"""Config #5's flags with the glimpse-local model (LGGlimpseSPAIR): the
``config5_glimpse`` factory against the README's command, and the port's
train step against the benchmark's frozen plain reference
(``benchmark/reference/lgglimpse.py``) at a small size (24-px canvases, a
2x2 cell grid, 16-px objects in 4-px patches, latents 8, B=4), from seeded
weights loaded by name, with the reference's draws replayed in order and the
render's seed the one the step draws.

Held: the loss and every metric of the step at rtol 1e-5; the first
gradients (both sides in float32, so each leaf within 1e-5 of its largest
entry, for the summation order; 1.2e-6 at most here); the parameters after Adam's first step at
Adam's rule; and the first half of every draw giving half the batch the same
patch permutation (the premise of the benchmark's half-batch fault)."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import common  # noqa: E402
from reference import lgglimpse as ref  # noqa: E402

from split_vae_torch.core.config import (  # noqa: E402
    CONFIG5G_ARGV,
    config5_glimpse,
    parse_spair_args,
)
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.core.state import create_train_state  # noqa: E402
from split_vae_torch.models.spair import get_spair_model  # noqa: E402
from split_vae_torch.train.losses import spair_loss  # noqa: E402
from split_vae_torch.train.optim import spair_optimizer  # noqa: E402
from split_vae_torch.train.steps import make_spair_train_step  # noqa: E402

B, HW = 4, 24
SMALL = dict(batch_size=B, image_size=(HW, HW, 3), test_size=(HW, HW, 3), object_size=16,
             patch_size=4, latent_size=8, bg_latent_size=8, local_latent_size=8)
CFG = config5_glimpse(**SMALL)
STATE_SEED = 5
METRICS = ("x_recon_loss", "z_zoom_kl_loss", "z_what_kl_loss", "z_where_kl_loss",
           "z_depth_kl_loss", "z_pres_kl_loss", "z_bg_kl_loss", "z_l_kl_loss",
           "x_hat_recon_loss", "total_loss")


def _spec():
    with open(os.path.join(BENCH, "configs", "config5g_lgglimpse.json")) as f:
        return json.load(f)


# What the reference reads: the benchmark's configuration file at the small size.
REF_CFG = {**_spec()["config"], **SMALL, "image_size": [HW, HW, 3]}


def test_config5_glimpse_is_the_readme_command():
    with open(os.path.join(ROOT, "BASELINE.md")) as f:
        readme = f.read()
    # Config #5's row of BASELINE.md, the model swapped.
    assert "spair/main.py " + " ".join(CONFIG5G_ARGV).replace(
        "lg_glimpse_spair", "lg_spair") in readme
    parsed = parse_spair_args(list(CONFIG5G_ARGV))
    assert dataclasses.replace(parsed, batch_size=256) == config5_glimpse()
    cfg = config5_glimpse()
    assert (cfg.model, cfg.object_size, cfg.patch_size, cfg.latent_size, cfg.bg_latent_size,
            cfg.local_latent_size, cfg.dense_bg, cfg.batch_size, cfg.image_size) == (
        "lg_glimpse_spair", 32, 8, 64, 64, 64, True, 256, (48, 48, 3))


def test_the_benchmark_runs_config5_glimpse_as_it_is():
    """The configuration file's values, handed to the factory as the harness
    hands them, change nothing."""
    spec = _spec()
    assert spec["port"] == {"family": "spair", "factory": "config5_glimpse"}
    assert spec["reference"] == "lgglimpse" and spec["reduced"] == []
    values = dict(spec["config"], image_size=tuple(spec["config"]["image_size"]),
                  test_size=tuple(spec["config"]["test_size"]))
    assert config5_glimpse(**values) == config5_glimpse()
    assert spec["dataset"] == {"count": 100000, "shape": [48, 48, 3], "dtype": "float32"}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(seed: int):
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in ref.model(REF_CFG).named_parameters()}
    return common.init_weights(shapes, seed, "cpu")


def _load(model, weights):
    params = dict(model.named_parameters())
    assert set(params) == set(weights)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
    return model


def _render_seed() -> int:
    """The step's one draw from its generator under replayed draws."""
    gen = torch.Generator().manual_seed(STATE_SEED)
    return int(torch.randint(0, 2**31 - 1, (1,), generator=gen, dtype=torch.int32))


@pytest.fixture(scope="module")
def steps():
    """One step of each side from the same weights, rows, draws and seed."""
    torch.set_num_threads(1)
    weights = _weights(4321)
    batch = torch.from_numpy(np.random.RandomState(5).uniform(0, 1, (B, HW, HW, 3))
                             .astype(np.float32))
    draws = ref.draws(REF_CFG, (B, HW, HW, 3), torch.Generator().manual_seed(7))
    seed = _render_seed()

    model = _load(get_spair_model(CFG, device="cpu"), weights)
    state = create_train_state(model, spair_optimizer(CFG.learning_rate), seed=STATE_SEED)
    state, metrics = make_spair_train_step(CFG)(state, batch, replay=draws)

    reference = ref.Step(REF_CFG, weights, "cpu")
    with torch.no_grad():
        ref_terms = ref.terms(reference.model(batch, draws, seed), batch, REF_CFG, 0)
    ref_loss, _ = reference.run(batch, draws, seed)

    # The first gradients, unclipped, of a fresh model on each side.
    port = _load(get_spair_model(CFG, device="cpu"), weights)
    noise = Noise(torch.Generator().manual_seed(STATE_SEED), draws)
    total, _ = spair_loss(port(batch, True, noise), batch, CFG, 0, training=True)
    assert noise.exhausted()
    port_grads = torch.autograd.grad(total, list(port.parameters()))
    plain = _load(ref.model(REF_CFG), weights)
    ref_total = ref.terms(plain(batch, draws, seed), batch, REF_CFG, 0)["total_loss"]
    ref_grads = torch.autograd.grad(ref_total, list(plain.parameters()))
    return dict(
        weights=weights, metrics=metrics, ref_terms=ref_terms, ref_loss=ref_loss,
        grads=(dict(zip([n for n, _ in port.named_parameters()], port_grads)),
               dict(zip([n for n, _ in plain.named_parameters()], ref_grads))),
        params=(dict(state.model.named_parameters()),
                dict(zip(reference.names, reference.params))),
        step=(state.step, reference.opt.count))


def test_the_loss_and_every_metric_match(steps):
    metrics, ref_terms = steps["metrics"], steps["ref_terms"]
    assert set(metrics) == set(METRICS) | {"notfinite_updates"}
    assert float(metrics["notfinite_updates"]) == 0.0
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(ref_terms[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["total_loss"]), steps["ref_loss"], rtol=1e-5)


def test_the_first_gradients_match(steps):
    port, want = steps["grads"]
    assert sorted(port) == sorted(want)
    for name, w in want.items():
        scale = float(w.abs().max())
        assert scale > 0.0, name
        np.testing.assert_allclose(port[name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_the_parameters_after_adams_first_step_match(steps):
    """Adam's first step moves each entry by lr * g / (|g| + eps): by lr where
    the gradient is well above eps (1e-7), on both sides alike; nearer eps a
    gradient's rounding moves the update, so the update is held there by the
    gradients' test alone."""
    assert steps["step"] == (1, 1)
    port, want = steps["params"]
    lr = CFG.learning_rate
    assert sorted(port) == sorted(want)
    for name, w in want.items():
        start = steps["weights"][name]
        p, w = port[name].detach(), w.detach()
        g = steps["grads"][1][name]
        assert float((p - start).abs().max()) <= lr * (1 + 1e-3), name
        assert float((w - start).abs().max()) <= lr * (1 + 1e-3), name
        sure = g.abs() >= 1e-5
        gap = (p - w).abs()
        assert float(torch.where(sure, gap, torch.zeros_like(gap)).max()) <= 1e-3 * lr, name


def test_half_of_every_draw_is_half_the_batchs_with_the_same_permutation():
    draws = ref.draws(REF_CFG, (B, HW, HW, 3), torch.Generator().manual_seed(3))
    cells = B * 4  # the 2x2 cell grid
    assert [tuple(t.shape) for t in draws] == [(B, 8), (cells, 4), (B, 16), (cells, 8),
                                               (cells, 8), (cells, 1), (cells, 1)]
    assert draws[2].dtype == torch.float64
    n = 16
    whole = Noise(torch.Generator(), draws[2:3]).batch_permutation(n, B)
    half = Noise(torch.Generator(), [draws[2][:B // 2]]).batch_permutation(n, B // 2)
    assert torch.equal(whole, half)
    assert sorted(whole.tolist()) == list(range(n))
