"""The span readers (``harness/spans.py``): device time and idle gaps charged
to the innermost span open at the launch, on synthetic intervals; the five
readers give None where there are no spans; the spans phase on the CPU at a
tiny size; and on the card, every synchronizing call of a few window steps
of each cell with the span it fell in, pinned."""

import copy
import threading
import time
import warnings

import pytest
import torch

import run
from harness import data, port, spec, spans, trace

READERS = ("loader_ms_per_step", "host_ms_per_step", "optimizer_host_ms_per_step",
           "optimizer_ms_per_step", "loss_ms_per_step")

# One step on the host: step [0, 100) holds forward [10, 40), decode [20, 30)
# inside it, loss [40, 50), backward [50, 80), optimizer [80, 95).
STEP = [("step", 0, 100), ("step.forward", 10, 40), ("forward.decode_render", 20, 30),
        ("step.loss", 40, 50), ("step.backward", 50, 80), ("step.optimizer", 80, 95)]


def test_an_operation_belongs_to_the_innermost_span_at_its_launch():
    launches = {1: 12, 2: 25, 3: 30, 4: 45, 5: 96, 6: 120, 7: 10}
    ops = [("a", 200, 210, 1), ("b", 210, 230, 2), ("c", 230, 231, 3), ("d", 231, 241, 4),
           ("e", 241, 243, 5), ("f", 300, 304, 6), ("g", 304, 305, 7)]
    got = spans.device_by_span(STEP, launches, ops)
    assert got == {"step.forward": 10 + 1 + 1, "forward.decode_render": 20, "step.loss": 10,
                   "step": 2, spans.OUTSIDE: 4}
    assert sum(got.values()) == sum(e - s for _, s, e, _ in ops)


def test_a_launch_from_another_thread_goes_by_its_time():
    """Autograd's thread launches the backward while the main thread waits in
    ``step.backward``: the launch is charged to the span open at its time."""
    stamps = {}

    def backward_thread():
        stamps[9] = 60
    worker = threading.Thread(target=backward_thread)
    worker.start()
    worker.join()
    got = spans.device_by_span(STEP, stamps, [("bwd_kernel", 400, 450, 9)])
    assert got == {"step.backward": 50}


def test_operations_with_no_launch_are_kept_apart():
    got = spans.device_by_span(STEP, {}, [("memcpy", 0, 5, 3)])
    assert got == {spans.UNLINKED: 5}


def test_idle_gaps_are_charged_to_the_span_open_when_they_begin():
    ops = [("a", 0, 15, 1), ("b", 14, 20, 2), ("c", 42, 50, 3), ("d", 85, 90, 4),
           ("e", 130, 140, 5)]
    got = spans.idle_by_span(STEP, ops)
    assert got == {"forward.decode_render": 22, "step.backward": 35, "step.optimizer": 40}
    assert spans.idle_by_span(STEP, ops[:1]) == {}


def test_innermost_edges():
    assert spans.innermost(STEP, [0, 10, 20, 30, 40, 99.9, 100, -1]) == [
        "step", "step.forward", "forward.decode_render", "step.forward", "step.loss", "step",
        None, None]


def _reader_values(t):
    return {name: run.reader(spec.ROOT, name).read(t) for name in READERS}


def test_the_readers_give_none_without_spans(monkeypatch):
    cell = spec.load_cell("c2_lgvae_fp32_b64")
    monkeypatch.setattr(spans, "_cache", {})
    no_device = trace.Trace(steps=2, device_ops=[], host_ops=[], step_s=0.02, cell=cell)
    assert _reader_values(no_device) == dict.fromkeys(READERS)
    monkeypatch.setattr(spans, "_cache", {})
    monkeypatch.setattr(spans.importlib.util, "find_spec", lambda name: None)
    no_tracer = trace.Trace(steps=2, device_ops=[("k", 0.0, 1.0)], host_ops=[], step_s=0.02,
                            cell=cell)
    assert _reader_values(no_tracer) == dict.fromkeys(READERS)
    monkeypatch.setattr(spans, "_cache", {cell.name: {"spans": {"step": {"host_ms": 2.0}}}})
    assert _reader_values(no_tracer) == {**dict.fromkeys(READERS), "host_ms_per_step": 2.0}


@pytest.mark.parametrize("name", ["tiny_spair_cell", "tiny_vae_cell"])
def test_the_spans_phase_on_the_cpu(tiny_root, name):
    """No device: the host's spans are read, nothing is launched in them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = spans.measure(spec.load_cell(name, tiny_root), 2**31 + 5, torch.device("cpu"),
                            step_s=0.01, block_s=0.0)
    finally:
        torch.set_num_threads(threads)
    table = got["spans"]
    assert got["profiled_steps"] == 2 and got["spans_steps"] == 4
    # every span of a step reached the profiled steps: the device time is charged by them
    assert got["profiled_spans"] == sum(row.get("calls", 0) for row in table.values())
    for span in ("step", "step.inputs", "step.forward", "step.loss", "step.backward",
                 "step.reduce", "step.optimizer", "loader.next", "metrics.update"):
        assert table[span]["calls"] == 1.0, span
        assert 0 <= table[span]["self_ms"] <= table[span]["host_ms"]
        assert table[span]["device_ms"] == 0.0
    assert ("forward.decode_render" in table) == (name == "tiny_spair_cell")
    assert table["step"]["host_ms"] <= got["step_ms"]
    assert got["device_ms"] == 0.0


def test_the_spans_phase_runs_in_a_process_of_its_own(tiny_root):
    got = spans.run_alone(spec.load_cell("tiny_vae_cell", tiny_root), 2**31 + 6, step_s=1.0,
                          device="cpu", timeout_s=300)
    assert got["spans_steps"] == 4 and got["spans"]["step"]["calls"] == 1.0


# ---------------------------------------------------------------- on the card

# Where the loop body synchronizes with the device, with the metrics' drain
# left out: (span, file of the Python call) of every synchronizing call in a
# few window steps that cross an epoch.
PINNED_SYNCS = {
    "c5_lgspair_fp32_b256": {
        ("loader.epoch", "loader.py"),            # the epoch's permutation, pageable
        ("step.forward", "stn.py"),               # the cell biases from Python lists
        ("forward.decode_render", "stn.py"),      # the same, in the decoder's paste
        ("step.loss", "count_prior.py"),          # torch.as_tensor(prior_prob)
        ("step.loss", "distributions.py"),        # _as: torch.as_tensor of a float
        ("step.optimizer", "optim.py"),           # Adam's torch.tensor(b1), (b2)
    },
    "c2_lgvae_fp32_b64": {
        ("loader.epoch", "loader.py"),
        ("step.optimizer", "optim.py"),
    },
}


def synchronizing_calls(cell, device, steps: int = 5):
    """[(span, file, line, thread)] of the synchronizing calls in ``steps``
    loop bodies of ``cell`` (the dataset cut to three batches, so an epoch
    starts every third step), under ``torch.cuda.set_sync_debug_mode("warn")``.
    The span is the innermost one open on the host when the warning came,
    whichever thread it came from, as the span readers charge a launch."""
    from split_vae_torch.core import tracing

    cell = copy.deepcopy(cell)
    cell.config["dataset"]["count"] = 3 * cell.traffic["batch_size"]
    seeds = data.derive(2**31 + 77)
    prog = port.build(cell, data.make_images(cell.config["dataset"], seeds.data, device),
                      seeds.state, seeds.loader, device)
    for _ in range(2):
        prog.window_step()
    torch.cuda.synchronize()
    found = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            found.append((time.perf_counter_ns(), filename.rsplit("/", 1)[-1], lineno,
                          threading.current_thread().name))

    tracing.enable(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")  # warns once of itself, not noted
            warnings.showwarning = note
            try:
                for _ in range(steps):
                    prog.state, m = prog.step(prog.state, next(prog.batches))
                    prog.metrics.update(m)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        tracing.enable(False)
        records = tracing.drain()
    opened = [(r.name, r.start_ns, r.end_ns) for r in records]
    at = spans.innermost(opened, [t for t, *_ in found])
    return [(span, *rest) for span, (_, *rest) in zip(at, found)]


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(PINNED_SYNCS))
def test_the_synchronizing_calls_are_pinned(card_device, name):
    calls = synchronizing_calls(spec.load_cell(name), card_device)
    print(f"{name}: synchronizing calls {sorted(set(calls), key=str)}")
    assert {(span, file) for span, file, _, _ in calls} == PINNED_SYNCS[name]
