"""Chained train steps of the port against the JAX package.

Each package's own train step runs K chained steps from the same flax
parameters (converted by ``interop/flax_params.py``), on the same uint8
batches, with the JAX draws replayed to the port in order and the render
noise at 0 (the JAX fused render in interpret mode, which drops it). The
JAX step is the jitted one that its loop runs, with its samplers wrapped
where ``test_torch_spair_step.py`` and ``test_torch_gm_vae.py`` wrap them;
here each wrapper keeps its draw as an output of the jitted call, so one
compile serves the K steps. The JAX programs of the three chains are
compiled side by side, each beside the tracing of the next.

A float32 chain is held only where no ReLU input lies within rounding of
its kink: one that does takes its sign from the order of the sums, and
Adam carries the dropped gradient on. Outside ``jit`` the JAX chain parts
from the jitted one so within a few steps, while the port's stays close to
the jitted one; from the port's own initialization one unit of
``ObjDecoder.Conv_0`` comes that close at the fourth step. So the float32
chains start from the JAX package's initialization, as the one-step tests
do; the float64 chain starts from the port's own.

Both states start at a step just before a boundary of the schedules, in the
loop's counter and in the optimizer's count alike, with the Adam moments at
zero, so the chain crosses it:

- LG-SPAIR in config #5's layout (``split_z_l``, ``concat_z_what``, dense
  background and local paths) at small widths and a 24-px canvas, from step
  9,995: the z_pres prior and the zoom prior reach their ends at step 9,999
  (``z_pres_anneal_step`` 10,000).
- BG-SPAIR, whose loss takes the beta warm-up (config #5's loss reads the raw
  beta), with ``anneal_until`` 10,002: the warm-up ends at step 10,001, inside
  the same chain as the z_pres anneal.
- LGGMVae in config #3's layout (the GM encoder, Adam on the staircase
  learning rate) at small widths, from the port's initialization carried to
  flax (``state_dict_to_flax``), in float64 on both sides, as the GM step's
  gradients are held (``test_torch_gm_vae.py``), from count 999,996: the
  learning rate steps from 1e-4 to 4e-5 at count 1,000,000. The port's step
  is made float64 by casting its normalized batch and its noise up (the JAX
  step's flax layers compute in float64 on the float32 batch).

The two SPAIR chains also run from step 0 with a fresh Adam state (count
0, moments zero), as a user's run starts: through the same compiled JAX
programs, since the step and the count are traced. These cross Adam's bias
correction at its largest (1 - 0.9 at the first step) and the z_pres,
zoom-prior and beta anneals at their starts, where no other chain looks.

Held: every step's metrics at rtol 1e-4; after the last step, every
parameter and both Adam moments of every parameter within 1e-4 of the JAX
tensor's L2 norm (||port - jax|| <= 1e-4 ||jax||, the measure chip_smoke.py's
P13 uses).
"""

import types
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import flax.linen as flax_nn  # noqa: E402
import split_vae_tpu.nn.common as jax_common  # noqa: E402
import split_vae_tpu.nn.encoders as jax_encoders  # noqa: E402
import split_vae_tpu.nn.spair_nets as jax_nets  # noqa: E402
import split_vae_tpu.ops.patches as jax_patches  # noqa: E402
from split_vae_torch.core.config import SpairConfig as PortSpairConfig  # noqa: E402
from split_vae_torch.core.state import create_train_state as torch_state  # noqa: E402
from split_vae_torch.interop.flax_params import (  # noqa: E402
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from split_vae_torch.models.spair import get_spair_model as torch_spair  # noqa: E402
from split_vae_torch.models.vae import get_vae_model as torch_vae  # noqa: E402
from split_vae_torch.train import steps as torch_steps  # noqa: E402
from split_vae_torch.train.chains import (  # noqa: E402
    adam_moments, at_count, float64_steps, metric_gap, tensor_gap)
from split_vae_torch.train.optim import gm_optimizer, spair_optimizer  # noqa: E402
from split_vae_tpu.core.config import SpairConfig, VaeConfig  # noqa: E402
from split_vae_tpu.core.state import create_train_state as jax_state  # noqa: E402
from split_vae_tpu.models.spair import get_spair_model as jax_spair  # noqa: E402
from split_vae_tpu.train import optim as jax_optim  # noqa: E402
from split_vae_tpu.train.loop import build_vae_model  # noqa: E402
from split_vae_tpu.train.steps import make_spair_train_step as jax_spair_step  # noqa: E402
from split_vae_tpu.train.steps import make_vae_train_step as jax_vae_step  # noqa: E402
from test_torch_gm_vae import HW as GM_HW  # noqa: E402
from test_torch_gm_vae import _port_config  # noqa: E402
from test_torch_spair_step import HW, _configs  # noqa: E402

K = 8
SPAIR_START = 9_995
GM_START = 999_996
RTOL = 1e-4
NORM_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lowered_init(model, x):
    """``model.init`` under jit, lowered; a SPAIR model initialises through
    the plain render, which holds no parameter and compiles faster than the
    interpreted kernel."""
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    return jax.jit(model.init, static_argnames=("training", "fused")).lower(
        {"params": key, "sample": key, "dropout": key}, x, training=True, fused=False)


def _state(model, init, x, tx, start):
    """``create_train_state`` with ``init`` for the model's own, at step and
    Adam count ``start``."""
    state = jax_state(types.SimpleNamespace(init=init, apply=model.apply), x, tx, seed=3)
    return state.replace(step=jnp.asarray(start, jnp.int32),
                         opt_state=at_count(state.opt_state, start, jnp.full_like))


def _batches(shape, seed):
    return [np.random.RandomState(seed + i).randint(0, 256, shape).astype(np.uint8)
            for i in range(K)]


class TracedDraws:
    """Wraps the JAX samplers where the one-step tests wrap them; each draw
    is kept as the traced array, so a jitted step returns it. ``take``
    orders them as the port draws: the scramble's uniforms, then the
    model's draws in call order, then the dropout keep masks."""

    def __init__(self, mp):
        self.scramble, self.sample, self.masks = [], [], []
        orig_reparams = (jax_nets.reparameterize, jax_encoders.reparameterize)
        orig_concrete = jax_nets.concrete_binary_pre_sigmoid_sample
        orig_gumbel, orig_scramble = jax_encoders.gumbel_softmax, jax_patches.batched_scramble
        orig_dropout = flax_nn.Dropout.__call__

        def reparameterizer(orig):
            def reparameterize(key, mean, sigma):
                self.sample.append(jax.random.normal(key, sigma.shape, dtype=sigma.dtype))
                return orig(key, mean, sigma)
            return reparameterize

        def concrete(key, log_odds, temperature, eps=1e-8):
            self.sample.append(jax.random.uniform(key, log_odds.shape, dtype=log_odds.dtype))
            return orig_concrete(key, log_odds, temperature, eps)

        def gumbel_softmax(key, logits, tau, eps=0.0):
            self.sample.append(jax.random.uniform(key, logits.shape, dtype=logits.dtype,
                                                  minval=eps))
            return orig_gumbel(key, logits, tau, eps)

        def scramble(key, x, size):
            b, h, w, _ = x.shape
            self.scramble.append(jax.random.uniform(key, (b, (h // size) * (w // size))))
            return orig_scramble(key, x, size)

        def dropout(module, inputs, deterministic=None, rng=None):
            det = module.deterministic if deterministic is None else deterministic
            if not det and module.rate > 0.0:
                if rng is None:
                    rng = module.make_rng(module.rng_collection)
                self.masks.append(jax.random.bernoulli(rng, 1.0 - module.rate, inputs.shape))
            return orig_dropout(module, inputs, deterministic, rng)

        mp.setattr(jax_nets, "reparameterize", reparameterizer(orig_reparams[0]))
        mp.setattr(jax_encoders, "reparameterize", reparameterizer(orig_reparams[1]))
        mp.setattr(jax_nets, "concrete_binary_pre_sigmoid_sample", concrete)
        mp.setattr(jax_encoders, "gumbel_softmax", gumbel_softmax)
        mp.setattr(jax_patches, "batched_scramble", scramble)
        mp.setattr(flax_nn.Dropout, "__call__", dropout)

    def take(self):
        out = self.scramble + self.sample + self.masks
        self.scramble, self.sample, self.masks = [], [], []
        return out


def _lowered_step(step, state, batch):
    """The jitted JAX step's body under one jit with its draws recorded by
    ``TracedDraws`` (a nested jit would keep them in its own trace), lowered
    for ``state`` (arrays or their shapes)."""
    with pytest.MonkeyPatch.context() as mp:
        draws = TracedDraws(mp)
        body = step.__wrapped__

        def recorded(state, batch):
            new_state, metrics = body(state, batch)
            return new_state, metrics, draws.take()

        return jax.jit(recorded).lower(state, batch)


def _jax_chain(step, state, batches):
    """K calls of the compiled recorded step; each step's metrics and draws."""
    metrics, replays = [], []
    for b in batches:
        state, m, d = step(state, jnp.asarray(b))
        metrics.append({k: float(v) for k, v in m.items()})
        replays.append([np.array(a) for a in d])
    return state, metrics, replays


def _port_chain(step, tstate, batches, replays):
    metrics = []
    for b, replay in zip(batches, replays):
        tstate, m = step(tstate, torch.from_numpy(b), replay)
        metrics.append({k: float(v) for k, v in m.items()})
    return tstate, metrics


def _finish(tmodel, j_state, tstate, j_metrics, t_metrics, start):
    """The two chains' metrics, and the parameters and moments by name."""
    names = [n for n, _ in tmodel.named_parameters()]
    j_mu, j_nu = adam_moments(j_state.opt_state)
    t_mu, t_nu = adam_moments(tstate.opt_state)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(
        metrics=(j_metrics, t_metrics),
        tensors={
            "params": (flax_to_state_dict(to_np(j_state.params), tmodel),
                       dict(tmodel.named_parameters())),
            "mu": (flax_to_state_dict(to_np(j_mu), tmodel), dict(zip(names, t_mu))),
            "nu": (flax_to_state_dict(to_np(j_nu), tmodel), dict(zip(names, t_nu))),
        },
        steps=(start, int(j_state.step), tstate.step),
    )


def _spair_configs(kind):
    if kind == "lg_spair":
        return _configs()
    port_cfg = PortSpairConfig(model="bg_spair", batch_size=4, latent_size=8, bg_latent_size=4,
                               object_size=16, anneal_until=10_002.0)
    port_cfg.image_size = (HW, HW, 3)
    return SpairConfig(**{**port_cfg.__dict__, "interpret_fused": True}), port_cfg


class Plan(NamedTuple):
    """One chain: its JAX programs, lowered, and what runs the chain once
    they are compiled (in that order)."""
    lowered: tuple
    run: Callable


def _spair_plan(kind):
    jax_cfg, port_cfg = _spair_configs(kind)
    b = port_cfg.batch_size
    batches = _batches((b, HW, HW, 3), 10)
    x = jnp.zeros((b, HW, HW, 6 if kind == "lg_spair" else 3))
    # As train/loop.py::train_spair builds it (Keras Adam, clipnorm 1).
    tx = jax_optim.nan_robust(optax.chain(jax_optim.clip_by_per_tensor_norm(1.0),
                                          jax_optim.adam(jax_cfg.learning_rate)))
    model = jax_spair(jax_cfg)
    lowered_init = _lowered_init(model, x)
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), lowered_init.out_info)
    shapes = jax.eval_shape(lambda: _state(model, lambda *a, **kw: zeros, x, tx, SPAIR_START))

    def run(init, step, start=SPAIR_START):
        state = _state(model, lambda rngs, x, **kw: init(rngs, x), x, tx, start)
        params0 = jax.tree.map(np.array, state.params)
        j_state, j_metrics, replays = _jax_chain(step, state, batches)
        tmodel = load_flax_params(torch_spair(port_cfg, device="cpu"), params0)
        tmodel.render_noise_scale = 0.0
        tstate = torch_state(tmodel, spair_optimizer(port_cfg.learning_rate), seed=0)
        tstate.step = start
        tstate.opt_state = at_count(tstate.opt_state, start, torch.full_like)
        tstate, t_metrics = _port_chain(torch_steps.make_spair_train_step(port_cfg), tstate,
                                        batches, replays)
        return _finish(tmodel, j_state, tstate, j_metrics, t_metrics, start)

    step = _lowered_step(jax_spair_step(jax_cfg), shapes, jnp.asarray(batches[0]))
    return Plan((lowered_init, step), run)


def _gm_plan():
    """LGGMVae from the port's own initialization (in float64 no ReLU input
    lies within rounding of its kink)."""
    port_cfg = _port_config("lggmvae")
    jax_cfg = VaeConfig(**port_cfg.__dict__)
    b = port_cfg.batch_size
    batches = _batches((b, *GM_HW, 3), 20)
    tmodel = torch_vae(port_cfg, GM_HW, device="cpu").double()
    # As train/loop.py::train_vae builds it: Adam on gm_lr_schedule.
    model, tx = build_vae_model(jax_cfg, GM_HW)
    step = jax_vae_step(jax_cfg)  # checks the float32 activation dtype: made first
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        params = jax.tree.map(jnp.asarray, state_dict_to_flax(tmodel.state_dict()))
        state = _state(model, lambda *a, **kw: {"params": params}, None, tx, GM_START)
        mp.setattr(jax_common, "_ACTIVATION_DTYPE", jnp.float64)
        lowered = _lowered_step(step, state, jnp.asarray(batches[0]))

    def run(step):
        with jax.enable_x64(True):
            j_state, j_metrics, replays = _jax_chain(step, state, batches)
            j_state = jax.tree.map(np.asarray, j_state)
        with float64_steps():
            tstate = torch_state(tmodel, gm_optimizer(port_cfg.learning_rate), seed=0)
            tstate.step = GM_START
            tstate.opt_state = at_count(tstate.opt_state, GM_START, torch.full_like)
            tstate, t_metrics = _port_chain(torch_steps.make_vae_train_step(port_cfg), tstate,
                                            batches, replays)
        return _finish(tmodel, j_state, tstate, j_metrics, t_metrics, GM_START)

    return Plan((lowered,), run)


@pytest.fixture(scope="module")
def chains():
    """Every chain: the JAX programs traced one after another and each
    compiled beside the tracing of the next (XLA compiles without the GIL);
    each chain runs once its own are compiled."""
    plans = {}
    with ThreadPoolExecutor(5) as pool:
        for kind, plan in (("lg_spair", lambda: _spair_plan("lg_spair")),
                           ("bg_spair", lambda: _spair_plan("bg_spair")), ("lggmvae", _gm_plan)):
            plan = plan()
            plans[kind] = plan, [pool.submit(lowered.compile) for lowered in plan.lowered]
        out = {}
        for kind, (plan, compiled) in plans.items():
            programs = [c.result() for c in compiled]
            out[kind] = plan.run(*programs)
            if kind != "lggmvae":  # the count is traced: the same programs from step 0
                out[kind + "_from_0"] = plan.run(*programs, start=0)
        return out


@pytest.fixture(params=["lg_spair", "bg_spair", "lggmvae", "lg_spair_from_0",
                        "bg_spair_from_0"])
def chain(request, chains):
    return chains[request.param]


def test_chains_cross_the_boundaries():
    """The schedules change inside the chains: the z_pres prior reaches 0.99,
    BG-SPAIR's beta warm-up its end, and the GM learning rate its next step."""
    from split_vae_tpu.train import schedules

    jax_cfg, _ = _configs()
    _, bg_cfg = _spair_configs("bg_spair")
    steps = jnp.arange(SPAIR_START, SPAIR_START + K, dtype=jnp.float32)
    for values, end in ((schedules.z_pres_prior_prob(steps, jax_cfg.z_pres_anneal_step), 0.99),
                        (schedules.beta_warmup(steps, bg_cfg.beta, bg_cfg.anneal_until),
                         bg_cfg.beta)):
        values = np.asarray(values)
        assert values[0] < end and values[-2] == values[-1] == np.float32(end)
    lr = np.asarray(schedules.gm_lr_schedule(1e-4)(jnp.arange(GM_START, GM_START + K)))
    assert lr[0] == np.float32(1e-4) and lr[-1] == np.float32(4e-5)


def test_chain_took_every_step(chain):
    start, j_step, t_step = chain["steps"]
    assert j_step == t_step == start + K


def test_chain_metrics_match_every_step(chain):
    gap, where = metric_gap(*chain["metrics"])
    print(f"\nlargest metric gap {gap:.3g} at {where}")
    assert gap <= RTOL, where


@pytest.mark.parametrize("what", ["params", "mu", "nu"])
def test_chain_state_matches_after_the_last_step(chain, what):
    gap, where = tensor_gap(*chain["tensors"][what])
    print(f"\n{what}: largest ||port - jax|| / ||jax|| {gap:.3g} at {where}")
    assert gap <= NORM_TOL, where
