"""The graphed train step (split_vae_torch/train/graphs.py) against the eager one.

A CUDA graph cannot be captured on the CPU, so the CPU tests hand
``GraphedStep`` a stand-in capture with a graph's semantics: the capture runs
nothing that lasts (the state is put back), the replay runs the captured
function again over the same static inputs and writes the same output
tensors, and leaves the Python state (``state.step``, the counters) alone.
While it replays, ``state.step`` reads what it read at the capture, as a
graph holds a host value it was captured with: a body that reads the host's
step bakes it in (``tests/test_torch_spair_graph.py``).
A toy body updates its state in place, as the fused optimizer does on the
card. The card test holds the real capture of config #4's step to the eager
step.
"""

from __future__ import annotations

import contextlib
import copy

import pytest

torch = pytest.importorskip("torch")

from split_vae_torch.core import tracing  # noqa: E402
from split_vae_torch.core.state import TrainState, tree_tensors  # noqa: E402
from split_vae_torch.train import graphs  # noqa: E402
from split_vae_torch.train.graphs import GraphedStep  # noqa: E402

torch.set_num_threads(1)
B, D, H = 4, 6, 5


class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(D, H)


def body(state, batch, noise):
    """A step with a uniform, a keep mask and a normal drawn; SGD in place."""
    u = noise.uniform((batch.shape[0], D), per_example=True)
    keep = noise.keep((batch.shape[0], H), 0.2, per_example=True)
    z = noise.normal((batch.shape[0], H))
    h = torch.where(keep, state.model.lin(batch + u) / 0.8, torch.zeros(())) + z
    loss = torch.mean(h ** 2)
    grads = torch.autograd.grad(loss, state.params)
    with torch.no_grad():
        for p, g in zip(state.params, grads):
            p.sub_(0.1 * g)
        state.opt_state[0].add_(1)
    state.step += 1
    tracing.count("toy.launch", 2)
    return {"loss": loss.detach(), "kept": keep.float().mean()}


def make_state(seed=0):
    torch.manual_seed(seed)
    return TrainState(step=0, model=Toy(), opt_state=(torch.zeros((), dtype=torch.int32),),
                      tx=None, generator=torch.Generator().manual_seed(seed + 1))


def computing_nothing(state, fn):
    """fn()'s Python, with what it computed in the state's tensors undone,
    as a capture computes nothing."""
    tensors = list(state.params) + tree_tensors(state.opt_state)
    saved = [t.detach().clone() for t in tensors]
    out = fn()
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)
    return out


def stand_in(log):
    """A capture with a CUDA graph's semantics, on the CPU (the module's docstring)."""
    def capture(fn):
        log.append("capture")
        state = log.state
        captured = state.step
        out = computing_nothing(state, fn)
        static = {k: v.detach().clone() for k, v in out.items()}

        def replay():
            log.append("replay")
            step, counted = state.step, tracing.counters()
            state.step = captured
            new = fn()
            for k, v in new.items():
                static[k].copy_(v)
            state.step = step
            for k, v in tracing.counters().items():
                tracing.count(k, counted.get(k, 0) - v)
        return replay, static
    return capture


class Log(list):
    state = None


# The start of the warning a failed capture gives (graphs.py); the card tests
# fail on it.
CAPTURE_FAILED = "a CUDA graph could not capture the train step"


def graphed(state, capture_log=None):
    log = Log() if capture_log is None else capture_log
    log.state = state
    return GraphedStep(body, capture=stand_in(log)), log


def batches(n, seed=5, rows=B):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((rows, D), generator=g) for _ in range(n)]


def replays(n, seed=9, rows=B):
    g = torch.Generator().manual_seed(seed)
    return [[torch.rand((rows, D), generator=g), torch.rand((rows, H), generator=g) < 0.8,
             torch.randn((rows, H), generator=g)] for _ in range(n)]


def run(step, state, n, replay=None, rows=B):
    out = []
    for i, batch in enumerate(batches(n, rows=rows)):
        state, m = step(state, batch, replay=None if replay is None else replay[i])
        out.append({k: v.clone() for k, v in m.items()})
    return out


def same_states(a, b):
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)
    assert torch.equal(a.opt_state[0], b.opt_state[0])
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def same_metrics(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("replayed", [False, True])
def test_graphed_steps_are_the_eager_steps(replayed):
    """Step for step, the same metrics, parameters, count, generator state
    and counters; one capture, then a replay a step."""
    n = 6
    draws = replays(n) if replayed else None
    eager_state, state = make_state(), make_state()
    step, log = graphed(state)
    before = tracing.counters().get("toy.launch", 0)
    want = run(step.eager, eager_state, n, draws)
    mid = tracing.counters().get("toy.launch", 0)
    got = run(step, state, n, draws)
    after = tracing.counters().get("toy.launch", 0)
    same_metrics(got, want)
    same_states(state, eager_state)
    assert log == ["capture"] + ["replay"] * (n - 1)
    assert after - mid == mid - before == 2 * n


def test_a_replaced_state_is_recorded_again():
    """A state whose optimizer tensors were replaced (as a restored or
    faulted state is) is run eagerly once more, then captured again."""
    eager_state, state = make_state(), make_state()
    step, log = graphed(state)
    want = run(step.eager, eager_state, 3) + run(step.eager, eager_state, 3)
    got = run(step, state, 3)
    state.opt_state = copy.deepcopy(state.opt_state)
    got += run(step, state, 3)
    same_metrics(got, want)
    same_states(state, eager_state)
    assert log == ["capture", "replay", "replay"] * 2


def test_each_batch_shape_has_its_graph():
    eager_state, state = make_state(), make_state()
    step, log = graphed(state)
    want = run(step.eager, eager_state, 3) + run(step.eager, eager_state, 3, rows=2)
    got = run(step, state, 3) + run(step, state, 3, rows=2)
    same_metrics(got, want)
    same_states(state, eager_state)
    assert len(step.shapes) == 2
    assert log.count("capture") == 2


def test_tracing_on_runs_the_eager_step():
    state = make_state()
    step, log = graphed(state)
    was = tracing.enabled()
    tracing.enable(True)
    try:
        tracing.drain()
        run(step, state, 3)
        names = [s.name for s in tracing.drain()]
    finally:
        tracing.enable(was)
    assert log == [] and not step.shapes
    assert names.count("step") == 3


def test_anomaly_mode_runs_the_eager_step():
    """--debug_nans turns on autograd's anomaly mode, which reads each
    gradient on the host: no capture."""
    eager_state, state = make_state(), make_state()
    step, log = graphed(state)
    want = run(step.eager, eager_state, 3)
    with torch.autograd.set_detect_anomaly(True):
        got = run(step, state, 3)
    same_metrics(got, want)
    same_states(state, eager_state)
    assert log == [] and not step.shapes


@pytest.mark.parametrize("rank", [0, 1])
def test_several_processes_run_the_eager_step(rank):
    """On a mesh of two data ranks the step neither records nor captures:
    every call runs eagerly, is counted so, and draws this rank's rows of
    the global batch's draws, as the 1-rank step draws them."""
    from split_vae_torch.parallel.mesh import Mesh

    def drawing(state, batch, noise):
        state.step += 1
        return {"u": noise.uniform((batch.shape[0], D), per_example=True)}

    state = make_state()
    log = Log()
    log.state = state
    step = GraphedStep(drawing, Mesh(rank=rank, world=2), capture=stand_in(log))
    before = tracing.counters()
    got = run(step, state, 3)
    after = tracing.counters()
    g = make_state().generator
    want = [torch.rand((2 * B, D), generator=g)[rank * B:(rank + 1) * B] for _ in range(3)]
    for m, w in zip(got, want):
        assert torch.equal(m["u"], w)
    assert log == [] and not step.shapes and state.step == 3
    assert {k: after.get(k, 0) - before.get(k, 0) for k in ("step.graphed", "step.eager")} \
        == {"step.graphed": 0, "step.eager": 3}


def test_a_failed_capture_leaves_the_step_eager():
    """A capture that raises (a body that waits for the card) costs
    nothing: the step runs eagerly on the draws it was given, and so do the
    later ones; one warning names the error."""
    eager_state, state = make_state(), make_state()

    def refuse(fn):
        # The body's Python runs, and leaves its marks on the state's Python
        # side, but the card computes nothing before the capture fails.
        computing_nothing(state, fn)
        raise RuntimeError("operation not permitted when stream is capturing")

    step = GraphedStep(body, capture=refuse)
    want = run(step.eager, eager_state, 4)
    with pytest.warns(RuntimeWarning, match=CAPTURE_FAILED) as warned:
        got = run(step, state, 4)
    same_metrics(got, want)
    same_states(state, eager_state)
    assert all(s.eager for s in step.shapes.values())
    failed = [str(w.message) for w in warned if CAPTURE_FAILED in str(w.message)]
    assert len(failed) == 1 and "RuntimeError: operation not permitted" in failed[0], failed


def test_a_body_that_replaces_the_state_stays_eager():
    """The foreach optimizer (the CPU's) returns new state tensors, which a
    graph cannot hold: the step stays eager and equal to it, and the
    dropped capture counts nothing."""
    def replacing(state, batch, noise):
        metrics = body(state, batch, noise)
        state.opt_state = (state.opt_state[0] + 0,)
        return metrics

    eager_state, state = make_state(), make_state()
    log = Log()
    log.state = state
    step = GraphedStep(replacing, capture=stand_in(log))
    want = run(step.eager, eager_state, 4)
    before = tracing.counters().get("toy.launch", 0)
    got = run(step, state, 4)
    assert tracing.counters()["toy.launch"] - before == 2 * 4
    same_metrics(got, want)
    same_states(state, eager_state)
    assert log == ["capture"]


def test_a_permutation_keeps_the_step_eager():
    def permuting(state, batch, noise):
        return body(state, batch[noise.permutation(batch.shape[0])], noise)

    eager_state, state = make_state(), make_state()
    log = Log()
    log.state = state
    step = GraphedStep(permuting, capture=stand_in(log))
    want = run(step.eager, eager_state, 3)
    got = run(step, state, 3)
    same_metrics(got, want)
    same_states(state, eager_state)
    assert log == []


def test_the_vae_step_on_the_cpu_is_the_eager_step():
    """make_vae_train_step on the CPU: the step and its ``eager`` take the
    same steps; under a stand-in capture the foreach optimizer keeps it
    eager."""
    from split_vae_torch.core.config import config4
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.train.loop import build_vae_model
    from split_vae_torch.train.steps import make_vae_train_step

    cfg = config4(batch_size=2, global_latent_dims=4, local_latent_dims=4, y_size=3)
    states, outs = [], []
    for graph in (False, True):
        torch.manual_seed(0)
        model, tx = build_vae_model(cfg, (16, 16), device="cpu")
        state = create_train_state(model, tx, seed=3)
        step = make_vae_train_step(cfg)
        if graph:
            log = Log()
            log.state = state
            step.capture, step.any_device = stand_in(log), True
        call = step if graph else step.eager
        g = torch.Generator().manual_seed(1)
        out = []
        for _ in range(3):
            batch = torch.randint(0, 256, (2, 16, 16, 3), dtype=torch.uint8, generator=g)
            state, m = call(state, batch)
            out.append({k: v.clone() for k, v in m.items()})
        states.append(state)
        outs.append(out)
    same_metrics(outs[1], outs[0])
    for p, q in zip(states[0].params, states[1].params):
        assert torch.equal(p, q)
    assert log == ["capture"]


CUDNN = ("benchmark", "benchmark_limit", "deterministic", "allow_tf32")


def cudnn_settings():
    return {k: getattr(torch.backends.cudnn, k) for k in CUDNN}


@pytest.fixture
def caller_cudnn():
    """The caller's cuDNN settings, none of them the autotuner's: the
    autotuner off, another limit, deterministic, TF32 allowed; put back
    after the test."""
    was = cudnn_settings()
    want = {"benchmark": False, "benchmark_limit": 3, "deterministic": True,
            "allow_tf32": True}
    for k, v in want.items():
        setattr(torch.backends.cudnn, k, v)
    yield want
    for k, v in was.items():
        setattr(torch.backends.cudnn, k, v)


def seeing(log, inner=body):
    """``inner``, logging the cuDNN settings each call of its Python saw."""
    def looking(state, batch, noise):
        log.append(cudnn_settings())
        return inner(state, batch, noise)
    return looking


# What each call of the body's Python sees, by the path that ran it.
TUNED = {"benchmark": True, "benchmark_limit": graphs.AUTOTUNE_LIMIT, "deterministic": True,
         "allow_tf32": False}


@pytest.mark.parametrize("path", ["recording", "fallback", "eager", "several processes"])
def test_the_body_runs_under_the_autotuner(path, caller_cudnn):
    """The body's Python runs with cuDNN's autotuner on, at the module's
    limit, TF32 off though the caller allows it, and ``deterministic`` as
    the caller set it: where it records a batch shape, on an eager fallback
    after a failed capture, in ``eager`` and on a mesh of several
    processes."""
    from split_vae_torch.parallel.mesh import Mesh

    def drawing(state, batch, noise):
        state.step += 1
        return {"u": noise.uniform((batch.shape[0], D), per_example=True)}

    def refuse(fn):
        computing_nothing(state, fn)
        raise RuntimeError("operation not permitted when stream is capturing")

    state = make_state()
    seen = []
    if path == "several processes":
        step = GraphedStep(seeing(seen, drawing), Mesh(rank=0, world=2))
    else:
        step = GraphedStep(seeing(seen), capture=refuse)
    if path == "fallback":
        with pytest.warns(RuntimeWarning, match=CAPTURE_FAILED):
            run(step, state, 4)
        seen = seen[2:]  # past the recording and the failed capture
    else:
        run(step.eager if path == "eager" else step, state, 1 if path == "recording" else 2)
    assert seen and all(s == TUNED for s in seen), seen
    assert cudnn_settings() == caller_cudnn


def test_the_capture_and_replays_run_under_the_callers_settings(caller_cudnn):
    """The recording alone tunes: the capture and the replays meet only
    shapes the recording met, under the caller's settings."""
    state = make_state()
    seen = []
    log = Log()
    log.state = state
    step = GraphedStep(seeing(seen), capture=stand_in(log))
    run(step, state, 4)
    assert log == ["capture", "replay", "replay", "replay"]
    assert seen[0] == TUNED
    assert seen[1:] == [caller_cudnn] * 4  # the capture, then three replays


@pytest.mark.parametrize("raises", [False, True])
@pytest.mark.parametrize("path", ["recording", "eager"])
def test_the_callers_cudnn_settings_come_back(path, raises, caller_cudnn):
    """After the body returns, and after it raises, cuDNN's settings are the
    caller's again."""
    def failing(state, batch, noise):
        out = body(state, batch, noise)
        if raises:
            raise ValueError("the body failed")
        return out

    state = make_state()
    step, _ = graphed(state)
    step.body = failing
    call = step if path == "recording" else step.eager
    with pytest.raises(ValueError) if raises else contextlib.nullcontext():
        call(state, batches(1)[0])
    assert cudnn_settings() == caller_cudnn


def test_the_autotuned_counter_counts_each_recorded_shape():
    """``step.autotuned`` counts a batch shape's first recording: once for
    each of two shapes, not on the replays, the eager calls or a second
    recording of a shape whose state was replaced."""
    state = make_state()
    step, log = graphed(state)
    before = tracing.counters().get("step.autotuned", 0)
    counted = []
    for rows in (B, 2):
        run(step, state, 4, rows=rows)
        counted.append(tracing.counters().get("step.autotuned", 0) - before)
    state.opt_state = copy.deepcopy(state.opt_state)
    run(step, state, 3)
    run(step.eager, state, 2)
    counted.append(tracing.counters().get("step.autotuned", 0) - before)
    assert counted == [1, 2, 2]
    assert log.count("capture") == 3 and log.count("replay") == 3 + 3 + 2


@pytest.mark.card
@pytest.mark.filterwarnings(f"error:{CAPTURE_FAILED}")
@pytest.mark.parametrize("replayed", [False, True])
def test_the_captured_gm_step_is_the_eager_step(replayed):
    """Config #4's step at a small size on the card, captured, against the
    eager step from the same weights and generator (cuDNN deterministic,
    its engines timed by the autotuner among the deterministic ones): five
    steps, the metrics to float32's rounding, the parameters within Adam's
    steps, three fused optimizer launches a step, one batch shape tuned."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    from split_vae_torch.core.config import config4
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.train.loop import build_vae_model
    from split_vae_torch.train.steps import make_vae_train_step

    card = torch.device("cuda", 0)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = config4(batch_size=8, global_latent_dims=16, local_latent_dims=16, y_size=6)
        # The step's draws as a recording of one step lists them: uniforms
        # stand in for every one (both sides replay the same).
        torch.manual_seed(0)
        model, tx = build_vae_model(cfg, (32, 32), device=card)
        probe = make_vae_train_step(cfg)
        probe(create_train_state(model, tx),
              torch.zeros((8, 32, 32, 3), dtype=torch.uint8, device=card))
        shapes = [(s, d) for s, d, _ in next(iter(probe.shapes.values())).draws]
        runs = []
        for graph in (False, True):
            torch.manual_seed(0)
            model, tx = build_vae_model(cfg, (32, 32), device=card)
            state = create_train_state(model, tx, seed=3)
            step = make_vae_train_step(cfg)
            call = step if graph else step.eager
            g = torch.Generator(device=card).manual_seed(1)
            before = tracing.counters()
            out = []
            for _ in range(5):
                batch = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, device=card,
                                      generator=g)
                draws = [torch.rand(s, dtype=d, device=card, generator=g)
                         for s, d in shapes] if replayed else None
                state, m = call(state, batch, replay=draws)
                out.append({k: v.clone() for k, v in m.items()})
            torch.cuda.synchronize()
            after = tracing.counters()
            runs.append((state, out, {k: after.get(k, 0) - before.get(k, 0)
                                      for k in ("optim.fused", "step.autotuned")}))
        (eager, want, n_eager), (state, got, n_graph) = runs
        assert state.step == eager.step == 5
        assert n_eager == {"optim.fused": 15, "step.autotuned": 0}
        assert n_graph == {"optim.fused": 15, "step.autotuned": 1}
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        # Captured, the step's sums need not keep the eager order: over five
        # steps the metrics agree to float32's rounding (1.28e-5 at most on
        # an H100), and no parameter is more than Adam's steps apart (a
        # near-zero gradient may take the other sign); a stale draw, batch
        # or state reads far outside both.
        gaps = [abs(float(x[k]) - float(y[k])) / max(abs(float(y[k])), 1e-3)
                for x, y in zip(got, want) for k in y]
        assert max(gaps) <= 1e-4, max(gaps)
        apart = max(float((p - q).abs().max()) for p, q in zip(state.params, eager.params))
        assert apart <= 5 * 2 * cfg.learning_rate, apart
        assert len(step.shapes) == 1 and next(iter(step.shapes.values())).replay is not None
    finally:
        torch.backends.cudnn.deterministic = was


# Config #5 (LG-SPAIR) through both renders, and the other SPAIR models: the
# model, its factory's extra fields, the windowed render. Every one is
# graphed, LGGlimpseSPAIR too: its patch permutation is a static uniform
# draw, argsorted on the card.
SPAIR_ON_CARD = [("lg_spair", {}, False), ("lg_spair", {}, True), ("bg_spair", {}, False),
                 ("spair", {}, False), ("lg_glimpse_spair", {"patch_size": 4}, False)]


@pytest.mark.card
@pytest.mark.filterwarnings(f"error:{CAPTURE_FAILED}")
@pytest.mark.parametrize("model, extra, windowed", SPAIR_ON_CARD,
                         ids=["config5", "config5-windowed", "bg_spair", "spair",
                              "lg_glimpse_spair"])
def test_the_captured_spair_step_is_the_eager_step(model, extra, windowed):
    """Config #5's step at a small size on the card, full canvas and
    windowed render (and the other SPAIR models' steps), captured, against
    the eager step from the same weights and generator (cuDNN
    deterministic, its engines timed by the autotuner among the
    deterministic ones): five steps over which the anneals move (they end at
    step 4), the metrics to float32's rounding, the parameters within Adam's
    steps, the generator where the eager step leaves it (one render seed a
    step), and four replays after the one recording, its shape tuned;
    LGGlimpseSPAIR's scramble counted once a step on both paths."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    from split_vae_torch.core.config import config5
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.optim import spair_optimizer
    from split_vae_torch.train.steps import make_spair_train_step

    card = torch.device("cuda", 0)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = config5(model=model, batch_size=8, latent_size=8, bg_latent_size=8,
                      local_latent_size=8, object_size=16, image_size=(24, 24, 3),
                      z_pres_anneal_step=4.0, anneal_until=4.0, **extra)
        runs = []
        for graph in (False, True):
            state = create_train_state(get_spair_model(cfg, device=card),
                                       spair_optimizer(cfg.learning_rate), seed=3)
            step = make_spair_train_step(cfg, windowed_render=windowed)
            call = step if graph else step.eager
            g = torch.Generator(device=card).manual_seed(1)
            before = tracing.counters()
            out = []
            for _ in range(5):
                batch = torch.rand((8, 24, 24, 3), device=card, generator=g)
                state, m = call(state, batch)
                out.append({k: v.clone() for k, v in m.items()})
            torch.cuda.synchronize()
            after = tracing.counters()
            runs.append((state, out, {k: after.get(k, 0) - before.get(k, 0)
                                      for k in ("step.graphed", "step.eager",
                                                "step.autotuned", "glimpse.scramble")}))
        (eager, want, n_eager), (state, got, n_graph) = runs
        assert state.step == eager.step == 5
        scrambles = 5 if model == "lg_glimpse_spair" else 0
        assert n_eager == {"step.graphed": 0, "step.eager": 5, "step.autotuned": 0,
                           "glimpse.scramble": scrambles}
        assert n_graph == {"step.graphed": 4, "step.eager": 1, "step.autotuned": 1,
                           "glimpse.scramble": scrambles}
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert torch.equal(state.generator.get_state(), eager.generator.get_state())
        gaps = [abs(float(x[k]) - float(y[k])) / max(abs(float(y[k])), 1e-3)
                for x, y in zip(got, want) for k in y]
        assert max(gaps) <= 1e-4, max(gaps)
        apart = max(float((p - q).abs().max()) for p, q in zip(state.params, eager.params))
        assert apart <= 5 * 2 * cfg.learning_rate, apart
        shape = next(iter(step.shapes.values()))
        assert shape.replay is not None
        assert shape.reads_step and len(shape.seeds) == 1
    finally:
        torch.backends.cudnn.deterministic = was


@pytest.mark.card
def test_the_anneals_on_the_card_are_the_floats():
    """The anneals' device forms on the card, bit for bit the floats (CUDA
    would turn a division by a Python number into a product)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    from test_torch_spair_graph import ANNEALS, anneal_steps

    for anneal in (4, 1_000, 3_000, 10_000):
        for s in anneal_steps(anneal):
            step = torch.full((), s, dtype=torch.float32, device="cuda")
            for f in ANNEALS:
                assert f(step).item() == f(s), (s, f(step).item(), f(s))
