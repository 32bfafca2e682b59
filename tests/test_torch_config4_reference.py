"""BASELINE config #4 (SPLIT-GMVAE on CelebA 64x64): the ``config4`` factory
against the README's command, and the port's LGGMVae train step against the
benchmark's frozen plain reference (``benchmark/reference/lggmvae.py``) at a
small size (16x16 images, latents 8, y_size 5, B=4), from seeded weights
loaded by name, with the reference's draws replayed in order.

Held: the loss and every metric of the step at rtol 1e-5; the first
gradients in float64 at rtol 1e-6 (in float32 the Gumbel softmax's backward
cancels, and the y block's gradients part from float64 by more than the
step's other leaves: ROADMAP C, "GM gradients in float32"); and the
parameters after Adam's first step at Adam's rule."""

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
from reference import lggmvae as ref  # noqa: E402

from split_vae_torch.core.config import (  # noqa: E402
    CONFIG4_ARGV,
    CONFIG4_IMAGE_HW,
    config4,
    parse_vae_args,
)
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.core.state import create_train_state  # noqa: E402
from split_vae_torch.models.vae import get_vae_model  # noqa: E402
from split_vae_torch.train.losses import lggmvae_loss  # noqa: E402
from split_vae_torch.train.optim import gm_optimizer  # noqa: E402
from split_vae_torch.train.steps import make_vae_train_step  # noqa: E402

HW, B = (16, 16), 4
CFG = config4(batch_size=B, global_latent_dims=8, local_latent_dims=8, y_size=5)
# What the reference reads, as the benchmark's configuration file gives it.
REF_CFG = {k: getattr(CFG, k) for k in ("model", "augmentation", "patch_size", "beta", "alpha",
                                        "y_size", "tau", "learning_rate",
                                        "global_latent_dims", "local_latent_dims")}
METRICS = ("x_recon_loss", "x_kl_loss", "x_hat_recon_loss", "x_hat_kl_loss", "y_kl_loss",
           "total_loss")


def test_config4_is_the_readme_command():
    with open(os.path.join(ROOT, "BASELINE.md")) as f:
        assert "vae/main.py " + " ".join(CONFIG4_ARGV) in f.read()  # config #4's row
    parsed = parse_vae_args(list(CONFIG4_ARGV))
    assert parsed.viz is True
    assert dataclasses.replace(parsed, viz=False) == config4()
    assert CONFIG4_IMAGE_HW == (64, 64)
    cfg = config4()
    assert (cfg.model, cfg.dataset, cfg.no_label, cfg.beta, cfg.alpha, cfg.y_size, cfg.tau,
            cfg.patch_size, cfg.batch_size) == ("lggmvae", "celeba64", True, 120.0, 40.0, 30,
                                                0.4, 8, 64)


def test_the_benchmark_runs_config4_as_it_is():
    """The configuration file's values, handed to the factory as the harness
    hands them, change nothing."""
    with open(os.path.join(BENCH, "configs", "config4_lggmvae.json")) as f:
        spec = json.load(f)
    assert spec["port"] == {"family": "vae", "factory": "config4"}
    assert spec["reference"] == "lggmvae" and spec["reduced"] == []
    assert config4(**spec["config"]) == config4()
    assert tuple(spec["dataset"]["shape"][:2]) == CONFIG4_IMAGE_HW


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(seed: int):
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in ref.model(REF_CFG, HW).named_parameters()}
    return common.init_weights(shapes, seed, "cpu")


def _load(model, weights):
    params = dict(model.named_parameters())
    assert set(params) == set(weights)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
    return model


@pytest.fixture(scope="module")
def steps():
    """One step of each side from the same weights, rows and draws."""
    torch.set_num_threads(1)
    weights = _weights(1234)
    batch = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (B, *HW, 3), np.uint8))
    draws = ref.draws(REF_CFG, (B, *HW, 3), torch.Generator().manual_seed(7))

    model = _load(get_vae_model(CFG, HW, device="cpu"), weights)
    state = create_train_state(model, gm_optimizer(CFG.learning_rate), seed=0)
    state, metrics = make_vae_train_step(CFG)(state, batch, replay=draws)

    reference = ref.Step(REF_CFG, weights, "cpu", HW)
    images = ref.images_of(batch, REF_CFG, draws[0])
    with torch.no_grad():
        ref_terms = ref.terms(reference.model, images, draws[1:], REF_CFG)
    ref_loss, ref_grads = reference.run(batch, draws, 0)

    # The first gradients in float64, from the same images and draws.
    images64 = images.double()
    draws64 = [d if d.dtype == torch.bool else d.double() for d in draws[1:]]
    port64 = _load(get_vae_model(CFG, HW, device="cpu"), weights).double()
    out = port64(images64, True, Noise(torch.Generator(), draws64, dtype=torch.float64))
    total, _ = lggmvae_loss(out, images64, CFG.beta, CFG.alpha, CFG.y_size)
    port_grads = torch.autograd.grad(total, list(port64.parameters()))
    ref64 = _load(ref.model(REF_CFG, HW), weights).double()
    ref_total = ref.terms(ref64, images64, draws64, REF_CFG)["total_loss"]
    ref_grads64 = torch.autograd.grad(ref_total, list(ref64.parameters()))
    return dict(
        weights=weights, metrics=metrics, ref_terms=ref_terms, ref_loss=ref_loss,
        grads64=(dict(zip([n for n, _ in port64.named_parameters()], port_grads)),
                 dict(zip([n for n, _ in ref64.named_parameters()], ref_grads64))),
        params=(dict(state.model.named_parameters()),
                dict(zip(reference.names, reference.params))),
        ref_grads=dict(zip(reference.names, ref_grads)),
        step=(state.step, reference.opt.count))


def test_the_loss_and_every_metric_match(steps):
    metrics, ref_terms = steps["metrics"], steps["ref_terms"]
    assert set(metrics) == set(METRICS) | {"notfinite_updates"}
    assert float(metrics["notfinite_updates"]) == 0.0
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(ref_terms[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["total_loss"]), steps["ref_loss"], rtol=1e-5)


def test_the_first_gradients_match_in_float64(steps):
    port, want = steps["grads64"]
    assert sorted(port) == sorted(want)
    for name, w in want.items():
        assert port[name].dtype == w.dtype == torch.float64
        scale = float(w.abs().max())
        assert scale > 0.0, name
        np.testing.assert_allclose(port[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-9 * scale, err_msg=name)


def test_the_parameters_after_adams_first_step_match(steps):
    """Adam's first step moves each entry by lr * g / (|g| + eps): by lr where
    the gradient is well above eps, on both sides alike."""
    assert steps["step"] == (1, 1)
    port, want = steps["params"]
    lr = CFG.learning_rate
    assert sorted(port) == sorted(want)
    for name, w in want.items():
        start = steps["weights"][name]
        p, w = port[name].detach(), w.detach()
        g = steps["ref_grads"][name]
        moved_port, moved_ref = (p - start).abs(), (w - start).abs()
        assert float(moved_port.max()) <= lr * (1 + 1e-3), name
        assert float(moved_ref.max()) <= lr * (1 + 1e-3), name
        sure = g.abs() >= 1e-5
        gap = (p - w).abs()
        assert float(torch.where(sure, gap, torch.zeros_like(gap)).max()) <= 1e-3 * lr, name
