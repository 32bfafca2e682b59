"""The port's tracer (split_vae_torch/core/tracing.py) on the CPU: spans
record nothing and enter no ``record_function`` while tracing is off; with
tracing on, a train step of each family gives the span tree of its layers
once a call, with self times that add up; the spans reach a running
``torch.profiler``; the loader's spans cover the making of a batch and not
the consumer's time; ``maybe_profile`` turns tracing on inside its block
only; the kernels' launch counters count."""

import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from split_vae_torch.core import tracing  # noqa: E402
from split_vae_torch.core.config import SpairConfig, VaeConfig  # noqa: E402
from split_vae_torch.core.logging import maybe_profile  # noqa: E402
from split_vae_torch.core.metrics import MeanMetrics  # noqa: E402
from split_vae_torch.core.state import create_train_state  # noqa: E402
from split_vae_torch.data.loader import (  # noqa: E402
    ArrayDataset,
    device_prefetch,
    device_resident_batches,
    iterate_batches,
)
from split_vae_torch.models.spair import get_spair_model  # noqa: E402
from split_vae_torch.models.vae import get_vae_model  # noqa: E402
from split_vae_torch.train.optim import spair_optimizer, vae_optimizer  # noqa: E402
from split_vae_torch.train.steps import make_spair_train_step, make_vae_train_step  # noqa: E402

# (span, parent) in the order the spans start, one train step.
SPAIR_TREE = [("step", None), ("step.inputs", "step"), ("step.forward", "step"),
              ("forward.decode_render", "step.forward"), ("step.loss", "step"),
              ("step.backward", "step"), ("step.reduce", "step"), ("step.optimizer", "step")]
VAE_TREE = [row for row in SPAIR_TREE if row[0] != "forward.decode_render"]
PORT_SPANS = {name for name, _ in SPAIR_TREE} | {"loader.next", "loader.epoch",
                                                 "metrics.update", "metrics.drain"}


@pytest.fixture(autouse=True)
def tracing_off():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.enable(False)
    tracing.drain()
    yield
    tracing.enable(False)
    tracing.drain()
    torch.set_num_threads(threads)


def _spair_step():
    cfg = SpairConfig(model="lg_spair", batch_size=2, latent_size=8, bg_latent_size=8,
                      local_latent_size=8, object_size=16, patch_size=4,
                      image_size=(24, 24, 3))
    state = create_train_state(get_spair_model(cfg, device="cpu"),
                               spair_optimizer(cfg.learning_rate), seed=1)
    x = torch.from_numpy(np.random.RandomState(1).uniform(0, 1, (2, 24, 24, 3))
                         .astype(np.float32))
    step = make_spair_train_step(cfg)
    return lambda: step(state, x)


def _vae_step():
    cfg = VaeConfig(model="lgvae", batch_size=4, patch_size=2, beta=1.0,
                    global_latent_dims=8, local_latent_dims=8)
    state = create_train_state(get_vae_model(cfg, (16, 16), device="cpu"), vae_optimizer(1e-4))
    raw = torch.from_numpy(np.random.RandomState(0).randint(0, 255, (4, 16, 16, 3), np.uint8))
    step = make_vae_train_step(cfg)
    return lambda: step(state, raw)


FAMILIES = {"spair": (_spair_step, SPAIR_TREE), "vae": (_vae_step, VAE_TREE)}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    make, tree = FAMILIES[request.param]
    return make(), tree


class CountingRecordFunction:
    """Stands in for ``torch.profiler.record_function`` and counts its entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        CountingRecordFunction.entered += 1

    def __exit__(self, *exc):
        return False


def test_tracing_off_records_nothing_and_enters_no_record_function(family, monkeypatch):
    step, tree = family
    monkeypatch.setattr(CountingRecordFunction, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", CountingRecordFunction)
    step()
    assert CountingRecordFunction.entered == 0
    assert tracing.drain() == []
    tracing.enable(True)
    step()
    assert CountingRecordFunction.entered == len(tree)
    assert len(tracing.drain()) == len(tree)


def test_tracing_off_leaves_no_span_in_a_running_profile(family):
    step, _ = family
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    assert not {e.name for e in prof.events()} & PORT_SPANS
    assert tracing.drain() == []


def test_one_step_gives_the_span_tree_once_a_call(family):
    step, tree = family
    tracing.enable(True)
    t0 = time.perf_counter_ns()
    step()
    t1 = time.perf_counter_ns()
    records = tracing.drain()
    assert [(r.name, r.parent) for r in sorted(records, key=lambda r: r.start_ns)] == tree
    root = next(r for r in records if r.name == "step")
    assert t0 <= root.start_ns and root.end_ns <= t1
    for r in records:
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    children = [r for r in records if r.parent == "step"]
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns
    own = tracing.self_ns(records)
    assert min(own) >= 0
    assert sum(own) == root.end_ns - root.start_ns
    assert own[records.index(root)] == (root.end_ns - root.start_ns) - sum(
        r.end_ns - r.start_ns for r in children)
    rows = tracing.summary(records)
    assert {k: v["calls"] for k, v in rows.items()} == {name: 1 for name, _ in tree}
    step()
    assert len(tracing.drain()) == len(tree)


def test_the_spans_reach_the_profiler_under_their_names(family):
    step, tree = family
    tracing.enable(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    names = [e.name for e in prof.events()]
    assert {name: names.count(name) for name, _ in tree} == {name: 1 for name, _ in tree}


def test_self_times_of_nested_spans():
    S = tracing.Span
    records = [S("b", "a", 10, 20), S("c", "a", 30, 35), S("d", "c", 31, 33),
               S("a", None, 0, 100), S("e", None, 200, 210)]
    assert tracing.self_ns(records) == [10, 3, 2, 85, 10]
    rows = tracing.summary(records + [S("e", None, 300, 301)])
    assert rows["e"] == {"calls": 2, "total_ns": 11, "self_ns": 11}


def _images(n=10):
    return ArrayDataset(np.arange(n * 4 * 4 * 3, dtype=np.float32).reshape(n, 4, 4, 3))


def test_loader_next_leaves_out_the_consumers_time():
    tracing.enable(True)
    batches = device_resident_batches(_images(), 4, repeat=True, seed=3, device="cpu")
    next(batches)
    c0 = time.perf_counter_ns()
    time.sleep(0.05)
    c1 = time.perf_counter_ns()
    next(batches)
    spans = [r for r in tracing.drain() if r.name == "loader.next"]
    assert len(spans) == 2
    assert spans[0].end_ns <= c0 and c1 <= spans[1].start_ns
    assert all(r.end_ns - r.start_ns < c1 - c0 for r in spans)


@pytest.mark.parametrize("path", ["resident", "prefetch"])
def test_loader_epoch_once_an_epoch(path):
    """10 images in batches of 4: two batches an epoch, so 7 batches (8 drawn
    behind the prefetch's two in flight) touch 4 epochs; the batches are the
    index stream's."""
    ds = _images()
    if path == "resident":
        batches = device_resident_batches(ds, 4, repeat=True, seed=3, device="cpu")
    else:
        batches = device_prefetch(iterate_batches(ds, 4, repeat=True, seed=3), device="cpu")
    tracing.enable(True)
    got = [next(batches) for _ in range(7)]
    records = tracing.drain()
    epochs = [r for r in records if r.name == "loader.epoch"]
    assert len(epochs) == 4
    assert {r.parent for r in epochs} == {"loader.next"}
    assert sum(r.name == "loader.next" for r in records) == 7
    want = iterate_batches(ds, 4, repeat=True, seed=3)
    for batch in got:
        np.testing.assert_array_equal(np.asarray(batch), next(want))


def test_loaders_end_with_their_data():
    ds = _images()
    assert len(list(device_resident_batches(ds, 4, device="cpu"))) == 2
    assert len(list(device_prefetch(iterate_batches(ds, 4), device="cpu"))) == 2
    assert len(list(device_prefetch(iter([]), device="cpu"))) == 0


def test_metrics_update_and_drain_spans():
    m = MeanMetrics()
    tracing.enable(True)
    m.update({"a": torch.tensor(1.0)})
    m.update({"a": torch.tensor(3.0)})
    assert m.result() == {"a": 2.0}
    assert [(r.name, r.parent) for r in tracing.drain()] == [
        ("metrics.update", None), ("metrics.update", None), ("metrics.drain", None)]


def test_maybe_profile_turns_tracing_on_inside_its_block_only(tmp_path):
    with maybe_profile(None, 3):
        assert not tracing.enabled()
    with maybe_profile(str(tmp_path), 3):
        assert tracing.enabled()
        with tracing.span("step"):
            torch.ones(3).sum()
    assert not tracing.enabled()
    assert tracing.drain() == []
    with open(os.path.join(tmp_path, "step_3", "trace.json")) as f:
        assert '"step"' in f.read()
    tracing.enable(True)
    with maybe_profile(str(tmp_path), 4):
        with tracing.span("step"):
            pass
    assert tracing.enabled()
    assert [r.name for r in tracing.drain()] == ["step"]


def test_counters_count_whatever_the_tracing():
    before = tracing.counters()
    tracing.count("test.counter")
    tracing.enable(True)
    tracing.count("test.counter", 2)
    after = tracing.counters()
    assert after["test.counter"] - before.get("test.counter", 0) == 3
    after["test.counter"] = -1
    assert tracing.counters()["test.counter"] != -1


def test_counters_lose_no_count_across_threads():
    """The backward's launches are counted on autograd's threads while other
    threads count: 16 threads, switching every microsecond, lose no update."""
    before = tracing.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [tracing.count("test.threads")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert tracing.counters()["test.threads"] - before == 16 * 2000
