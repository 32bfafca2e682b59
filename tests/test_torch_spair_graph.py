"""The SPAIR train step as a CUDA graph (split_vae_torch/train/graphs.py), on
the CPU under the stand-in capture of ``tests/test_torch_graphs.py``.

- A body that draws a render seed (``Noise.seed``) is captured and replayed,
  with the seed a static draw made before each replay: the same metrics,
  parameters and generator state as the eager step's, with and without
  replayed draws (the seed is drawn from the generator either way).
- The stand-in replays with ``state.step`` at its capture value, so a body
  that reads the host's step bakes it in. A body whose loss
  (``losses.spair_loss``) reads the device step (``Noise.step``) gives the
  eager step's metrics bit for bit while the anneals move.
- The anneals' device forms equal ``train/schedules.py``'s floats bit for bit.
- ``step.graphed`` and ``step.eager`` count the path each call took.
- The SPAIR step's recording sees its render seed and its step read; the
  VAE family's steps (configs #2 and #4) record neither, and record and
  capture as before.
- A body that draws a batch permutation (``Noise.batch_permutation``, the
  glimpse scramble's) is captured and replayed, the permutation's uniforms
  a static draw made before each replay: the eager step's metrics,
  parameters and generator state, with and without replayed draws, and a
  new permutation most steps. The first half of a replayed draw gives the
  same permutation to half the batch; LGGlimpseSPAIR's step records the
  draw at [B, n] in float64 and counts one scramble a step.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_graphs import (  # noqa: E402
    B,
    CAPTURE_FAILED,
    D,
    H,
    Log,
    make_state,
    replays,
    run,
    same_metrics,
    same_states,
    stand_in,
)

from split_vae_torch.core import tracing  # noqa: E402
from split_vae_torch.core.config import SpairConfig, config2, config4, config5  # noqa: E402
from split_vae_torch.core.state import TrainState, create_train_state  # noqa: E402
from split_vae_torch.models.spair import SpairOutput, get_spair_model  # noqa: E402
from split_vae_torch.train import losses, schedules  # noqa: E402
from split_vae_torch.train.graphs import GraphedStep  # noqa: E402
from split_vae_torch.train.optim import spair_optimizer  # noqa: E402
from split_vae_torch.train.steps import make_spair_train_step, make_vae_train_step  # noqa: E402

torch.set_num_threads(1)


def graphed(body_fn, state):
    log = Log()
    log.state = state
    return GraphedStep(body_fn, capture=stand_in(log)), log


def seeded(state, batch, noise):
    """The toy step of ``test_torch_graphs.py`` with a render seed drawn
    between its draws and read into the loss and the metrics."""
    u = noise.uniform((batch.shape[0], D), per_example=True)
    seed = noise.seed()
    keep = noise.keep((batch.shape[0], H), 0.2, per_example=True)
    z = noise.normal((batch.shape[0], H))
    x = batch + u + (seed % 1000).to(batch.dtype) * 1e-4
    h = torch.where(keep, state.model.lin(x) / 0.8, torch.zeros(())) + z
    loss = torch.mean(h ** 2)
    grads = torch.autograd.grad(loss, state.params)
    with torch.no_grad():
        for p, g in zip(state.params, grads):
            p.sub_(0.1 * g)
        state.opt_state[0].add_(1)
    state.step += 1
    return {"loss": loss.detach(), "seed": seed.to(torch.float64)[0]}


@pytest.mark.parametrize("replayed", [False, True])
def test_a_body_that_draws_a_render_seed_is_graphed(replayed):
    n = 6
    draws = replays(n) if replayed else None
    eager_state, state = make_state(), make_state()
    step, log = graphed(seeded, state)
    want = run(step.eager, eager_state, n, draws)
    got = run(step, state, n, draws)
    same_metrics(got, want)
    same_states(state, eager_state)
    assert log == ["capture"] + ["replay"] * (n - 1)
    shape = next(iter(step.shapes.values()))
    assert shape.seeds == [1] and not shape.reads_step and shape.step is None
    assert len({float(m["seed"]) for m in got}) == n  # a fresh seed every step


def test_under_replay_the_seed_is_the_generators_only_draw():
    """Graphed, as eagerly: with every other draw replayed, n steps advance
    the generator by n seeds and nothing else."""
    n = 5
    state = make_state()
    step, _ = graphed(seeded, state)
    got = run(step, state, n, replays(n))
    gen = make_state().generator
    want = [int(torch.randint(0, 2**31 - 1, (1,), generator=gen, dtype=torch.int32))
            for _ in range(n)]
    assert [int(m["seed"]) for m in got] == want
    assert torch.equal(state.generator.get_state(), gen.get_state())


def test_a_replay_of_other_draws_draws_nothing_for_the_graph():
    """Replayed draws that are not the recorded ones go to the eager step,
    which refuses them, and the graph's draws (the seed among them) were
    not made: the generator is where it was."""
    state = make_state()
    step, _ = graphed(seeded, state)
    draws = replays(3)
    run(step, state, 2, draws[:2])
    before = state.generator.get_state()
    with pytest.raises(ValueError, match="replayed noise"):
        step(state, torch.rand((B, D)), replay=[d[:2] for d in draws[2]])
    assert torch.equal(state.generator.get_state(), before)


# -------------------------------------------------------------- the batch permutation

def permuting(state, batch, noise):
    """The toy step of ``test_torch_graphs.py`` with its features in the order
    of a batch permutation, drawn between its draws."""
    u = noise.uniform((batch.shape[0], D), per_example=True)
    perm = noise.batch_permutation(D, batch.shape[0])
    keep = noise.keep((batch.shape[0], H), 0.2, per_example=True)
    z = noise.normal((batch.shape[0], H))
    h = torch.where(keep, state.model.lin((batch + u)[:, perm]) / 0.8, torch.zeros(())) + z
    loss = torch.mean(h ** 2)
    grads = torch.autograd.grad(loss, state.params)
    with torch.no_grad():
        for p, g in zip(state.params, grads):
            p.sub_(0.1 * g)
        state.opt_state[0].add_(1)
    state.step += 1
    return {"loss": loss.detach(), "perm": perm}


def permutation_replays(n, rows=B):
    """``replays(n)`` with each step's permutation uniforms in their place."""
    g = torch.Generator().manual_seed(12)
    return [[u, torch.rand((rows, D), generator=g, dtype=torch.float64), keep, z]
            for u, keep, z in replays(n, rows=rows)]


@pytest.mark.parametrize("replayed", [False, True])
def test_a_body_that_draws_a_batch_permutation_is_graphed(replayed):
    n = 6
    draws = permutation_replays(n) if replayed else None
    eager_state, state = make_state(), make_state()
    step, log = graphed(permuting, state)
    want = run(step.eager, eager_state, n, draws)
    got = run(step, state, n, draws)
    same_metrics(got, want)
    same_states(state, eager_state)
    assert log == ["capture"] + ["replay"] * (n - 1)
    shape = next(iter(step.shapes.values()))
    assert not shape.eager and shape.seeds == []
    assert [(s, d) for s, d, _ in shape.draws][1] == ((B, D), torch.float64)
    perms = {tuple(m["perm"].tolist()) for m in got}
    assert all(sorted(p) == list(range(D)) for p in perms) and len(perms) > 1


def test_half_a_replayed_permutation_draw_is_the_same_permutation():
    from split_vae_torch.core.noise import Noise

    u = torch.rand((8, 16), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    whole = Noise(torch.Generator(), [u]).batch_permutation(16, 8)
    half = Noise(torch.Generator(), [u[:4]]).batch_permutation(16, 4)
    assert torch.equal(whole, half) and torch.equal(whole, torch.argsort(u[0]))
    # Two data ranks of 4 rows take the draw at the global batch and the same permutation.
    for rank in (0, 1):
        drawn = Noise(torch.Generator(), [u], rank=rank, world=2).batch_permutation(16, 4)
        assert torch.equal(drawn, whole)


def test_the_glimpse_step_records_its_permutation_draw():
    """LGGlimpseSPAIR's train step on the CPU: its recording holds the
    permutation's [B, n] float64 draw, after z_where's normals and before
    z_what's, its render seed last; it stays eager (the CPU's foreach
    optimizer), equal to its ``eager``, and counts a scramble a step."""
    from split_vae_torch.core.config import config5_glimpse

    cfg = config5_glimpse(batch_size=2, latent_size=8, bg_latent_size=8, local_latent_size=8,
                          object_size=16, patch_size=4, image_size=(24, 24, 3))
    x = torch.rand((2, 24, 24, 3), generator=torch.Generator().manual_seed(2))
    outs, states = [], []
    for graph in (False, True):
        torch.manual_seed(0)
        state = create_train_state(get_spair_model(cfg, device="cpu"),
                                   spair_optimizer(cfg.learning_rate), seed=3)
        step = make_spair_train_step(cfg)
        if graph:
            log = Log()
            log.state = state
            step.capture, step.any_device = stand_in(log), True
        before = tracing.counters().get("glimpse.scramble", 0)
        out = []
        for _ in range(3):
            state, m = (step if graph else step.eager)(state, x)
            out.append({k: v.clone() for k, v in m.items()})
        assert tracing.counters()["glimpse.scramble"] - before == 3
        outs.append(out)
        states.append(state)
    same_metrics(outs[1], outs[0])
    assert torch.equal(states[0].generator.get_state(), states[1].generator.get_state())
    assert log == ["capture"]
    shape = next(iter(step.shapes.values()))
    drawn = [(s, d) for s, d, _ in shape.draws]
    # The background's normals, z_where's, the permutation, z_what's, z_l's,
    # z_depth's, the presence uniforms, the render seed.
    assert drawn[2] == ((2, 16), torch.float64) and len(drawn) == 8
    assert shape.seeds == [7] and shape.eager


# -------------------------------------------------------------- the step's count

GH = GW = 2
WHAT, HW, C = 3, 4, 3


class SpairToy(torch.nn.Module):
    """A linear map of the image to every SpairOutput field BG-SPAIR's loss
    reads, in their ranges."""

    SIZES = dict(x=HW * HW * C, what=GH * GW * WHAT * 2, where=GH * GW * 8, depth=GH * GW * 2,
                 pres=GH * GW * 2, bg=4)

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(HW * HW * C, sum(self.SIZES.values()))

    def forward(self, images, noise):
        h = self.lin(images.reshape(images.shape[0], -1))
        parts = dict(zip(self.SIZES, torch.split(h, list(self.SIZES.values()), dim=1)))
        b = images.shape[0]
        cell = lambda t, n: t.reshape(b, GH, GW, n)  # noqa: E731
        what_m, what_s = torch.chunk(cell(parts["what"], 2 * WHAT), 2, dim=-1)
        where_m, where_s = torch.chunk(cell(parts["where"], 8), 2, dim=-1)
        depth_m, depth_s = torch.chunk(cell(parts["depth"], 2), 2, dim=-1)
        logits, pre = torch.chunk(cell(parts["pres"], 2), 2, dim=-1)
        bg_m, bg_s = torch.chunk(parts["bg"], 2, dim=-1)
        sig = lambda t: torch.nn.functional.softplus(t) + 0.1  # noqa: E731
        pres = torch.sigmoid(pre + noise.normal((b, GH, GW, 1), per_example=True))
        return SpairOutput(
            x_recon=torch.sigmoid(parts["x"]).reshape(images.shape),
            z_what=what_m, z_what_mean=what_m, z_what_sigma=sig(what_s),
            z_where=where_m, z_where_mean=where_m, z_where_sigma=sig(where_s),
            z_depth=depth_m, z_depth_mean=depth_m, z_depth_sigma=sig(depth_s),
            z_pres=pres, z_pres_logits=logits, z_pres_pre_sigmoid=pre,
            all_glimpses=None, obj_recon_unnorm=None, obj_recon_alpha=None,
            obj_full_recon_unnorm=None, obj_bbox_mask=None,
            z_bg_mean=bg_m, z_bg_sig=sig(bg_s))


ANNEALED = SpairConfig(model="bg_spair", z_pres_anneal_step=4.0, anneal_until=4.0, beta=0.7,
                       prior_z_zoom=-1.0, prior_z_zoom_start=3.0)


def spair_body(step_of):
    """A step whose loss is BG-SPAIR's, with its three anneals, at the step
    ``step_of(state, noise)``; SGD in place."""

    def step_body(state, batch, noise):
        out = state.model(batch, noise)
        total, metrics = losses.spair_loss(out, batch, ANNEALED, step_of(state, noise))
        grads = torch.autograd.grad(total, state.params)
        with torch.no_grad():
            for p, g in zip(state.params, grads):
                p.sub_(1e-3 * g)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step_body


def spair_state():
    torch.manual_seed(3)
    return TrainState(step=0, model=SpairToy(), opt_state=(), tx=None,
                      generator=torch.Generator().manual_seed(4))


def spair_run(step, state, n=6):
    g = torch.Generator().manual_seed(6)
    out = []
    for _ in range(n):
        state, m = step(state, torch.rand((B, HW, HW, C), generator=g))
        out.append({k: v.clone() for k, v in m.items()})
    return out


def test_the_graphed_anneals_read_the_device_step():
    """Over 6 steps the anneals move (to step 4) and stop: read from the
    device step, the graphed metrics are the eager ones bit for bit; read
    from the host's step, the graph bakes in the step it was captured at."""
    device_step = spair_body(lambda state, noise: noise.step())
    eager_state, state = spair_state(), spair_state()
    step, log = graphed(device_step, state)
    want = spair_run(step.eager, eager_state)
    got = spair_run(step, state)
    same_metrics(got, want)
    assert log == ["capture"] + ["replay"] * 5
    shape = next(iter(step.shapes.values()))
    assert shape.reads_step and shape.seeds == [] and shape.step.dtype == torch.float32
    totals = [float(m["total_loss"]) for m in want]
    assert len(set(totals)) == len(totals)

    host_step = spair_body(lambda state, noise: state.step)
    baked_state = spair_state()
    baked, _ = graphed(host_step, baked_state)
    stale = spair_run(baked, baked_state)
    same_metrics(stale[:2], want[:2])  # recorded at step 0, captured at step 1
    assert all(s["total_loss"] != w["total_loss"] for s, w in zip(stale[2:], want[2:]))


ANNEALS = [
    lambda s: schedules.z_pres_prior_prob(s, 10_000.0),
    lambda s: schedules.z_pres_prior_prob(s, 4.0),
    lambda s: schedules.z_zoom_prior_mean(s, 0.0, 10.0, 10_000.0),
    lambda s: schedules.z_zoom_prior_mean(s, -1.5, 4.0, 3_000.0),
    lambda s: schedules.z_zoom_prior_mean(s, 0.3, 7.1, 4.0),
    lambda s: schedules.beta_warmup(s, 0.5, 1.0),
    lambda s: schedules.beta_warmup(s, 2.0, 1_000.0),
    lambda s: schedules.beta_warmup(s, 0.7, 4.0),
    lambda s: schedules.beta_warmup(s, 0.3, 10_000.0),
]


def anneal_steps(anneal):
    return sorted({0, 1, anneal - 1, anneal, anneal + 1, 10**6, 199_999, 3})


@pytest.mark.parametrize("i", range(len(ANNEALS)))
def test_the_device_anneals_are_the_floats(i):
    for anneal in (4, 1_000, 3_000, 10_000):
        for s in anneal_steps(anneal):
            got = ANNEALS[i](torch.full((), s, dtype=torch.float32))
            want = ANNEALS[i](s)
            assert got.dtype == torch.float32 and got.shape == ()
            assert got.item() == want and np.float32(want) == want, (s, got.item(), want)


# -------------------------------------------------------------- the counters

def moved(before):
    after = tracing.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in ("step.graphed", "step.eager")}


def test_the_counters_say_which_path_ran():
    state = make_state()
    step, _ = graphed(seeded, state)
    before = tracing.counters()
    run(step, state, 5)
    assert moved(before) == {"step.graphed": 4, "step.eager": 1}

    before = tracing.counters()
    was = tracing.enabled()
    tracing.enable(True)
    try:
        run(step, state, 2)
    finally:
        tracing.enable(was)
        tracing.drain()
    assert moved(before) == {"step.graphed": 0, "step.eager": 2}

    before = tracing.counters()
    run(GraphedStep(seeded), make_state(), 3)  # the CPU, no stand-in: never captured
    assert moved(before) == {"step.graphed": 0, "step.eager": 3}

    def refuse(fn):
        raise RuntimeError("operation not permitted when stream is capturing")

    failing = make_state()
    before = tracing.counters()
    eager_state = make_state()
    with pytest.warns(RuntimeWarning, match=CAPTURE_FAILED):
        got = run(GraphedStep(seeded, capture=refuse), failing, 3)
    assert moved(before) == {"step.graphed": 0, "step.eager": 3}
    same_metrics(got, run(GraphedStep(seeded).eager, eager_state, 3))
    same_states(failing, eager_state)


# -------------------------------------------------------------- the ports' steps

def tiny_spair():
    cfg = config5(batch_size=2, latent_size=8, bg_latent_size=8, local_latent_size=8,
                  object_size=16, image_size=(24, 24, 3))
    return cfg, torch.rand((2, 24, 24, 3), generator=torch.Generator().manual_seed(2))


def test_the_spair_step_records_its_seed_and_its_step():
    """On the CPU the foreach optimizer replaces its state, so the capture
    is dropped and the step stays eager, equal to its ``eager``; its
    recording saw the render seed, the last draw, and the step read."""
    cfg, x = tiny_spair()
    outs, states = [], []
    for graph in (False, True):
        torch.manual_seed(0)
        state = create_train_state(get_spair_model(cfg, device="cpu"),
                                   spair_optimizer(cfg.learning_rate), seed=3)
        state.step = 9_998
        step = make_spair_train_step(cfg)
        if graph:
            log = Log()
            log.state = state
            step.capture, step.any_device = stand_in(log), True
        call = step if graph else step.eager
        out = []
        for _ in range(3):
            state, m = call(state, x)
            out.append({k: v.clone() for k, v in m.items()})
        outs.append(out)
        states.append(state)
    same_metrics(outs[1], outs[0])
    for p, q in zip(states[0].params, states[1].params):
        assert torch.equal(p, q)
    assert torch.equal(states[0].generator.get_state(), states[1].generator.get_state())
    assert log == ["capture"]
    shape = next(iter(step.shapes.values()))
    assert shape.eager and shape.reads_step and shape.seeds == [len(shape.draws) - 1]


@pytest.mark.parametrize("factory", [config2, config4], ids=["config2", "config4"])
def test_the_vae_steps_record_no_seed_and_no_step(factory):
    from split_vae_torch.train.loop import build_vae_model

    cfg = factory(batch_size=2, global_latent_dims=4, local_latent_dims=4)
    torch.manual_seed(0)
    model, tx = build_vae_model(cfg, (16, 16), device="cpu")
    state = create_train_state(model, tx, seed=3)
    step = make_vae_train_step(cfg)
    log = Log()
    log.state = state
    step.capture, step.any_device = stand_in(log), True
    batch = torch.randint(0, 256, (2, 16, 16, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1))
    for _ in range(2):
        state, _ = step(state, batch)
    shape = next(iter(step.shapes.values()))
    assert shape.seeds == [] and not shape.reads_step and shape.step is None
    assert len(shape.buffers) == len(shape.draws) > 0
    assert log == ["capture"]
