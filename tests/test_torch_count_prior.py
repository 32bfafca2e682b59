"""split_vae_torch.ops.count_prior against split_vae_tpu.ops.count_prior, and
the kernel pair's closed-form backward (split_vae_torch.kernels.count_prior)
against the loop's autograd and the JAX package.

Values and the gradients with respect to the logits and the pre-sigmoid
sample (z_pres enters only through its > 0.5 threshold); rtol 1e-5, atol
1e-6. The closed form is held as the backward of the loop's forward, fed
the prior log-odds the loop computed for each cell, as the backward kernel
is fed the forward kernel's. XLA's CPU backend flushes subnormal floats to
zero, and at 36 cells and a prior of 0.99 the prior's mass on 19 and more
objects is subnormal in float32 (0.01^19): that pair is held to the JAX
package with torch's flush on too (``set_flush_denormal``), and to the
loop's autograd without it, as the card computes. Where ``exp`` overflows,
the loss is infinite and the gradients hold NaN in the same places on all
three sides. On the CPU, in float32 and float64, ``z_pres_count_kl`` runs
the loop and launches nothing; the kernels' entry points take CUDA float32
tensors alone (the card's checks are in ``chip_smoke.py::run_count_prior``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.core import tracing  # noqa: E402
from split_vae_torch.kernels import count_prior as tcp  # noqa: E402
from split_vae_torch.ops import count_prior as tops  # noqa: E402
from split_vae_torch.ops.count_prior import z_pres_count_kl as torch_kl  # noqa: E402
from split_vae_tpu.ops.count_prior import z_pres_count_kl as jax_kl  # noqa: E402

TAU = 0.8


def _inputs(seed, b, gh, gw):
    rng = np.random.RandomState(seed)
    logits = rng.uniform(-10, 10, (b, gh, gw, 1)).astype(np.float32)
    u = rng.uniform(0.01, 0.99, logits.shape).astype(np.float32)
    pre = ((logits + np.log(u) - np.log(1 - u)) / TAU).astype(np.float32)
    pres = (1.0 / (1.0 + np.exp(-pre))).astype(np.float32)
    return pres, logits, pre


@pytest.mark.parametrize("grid,prior_prob", [((2, 2), 0.3), ((4, 4), 0.99), ((4, 4), 1e-4),
                                             ((3, 2), 0.5)])
def test_count_kl_value_and_grads(grid, prior_prob):
    pres, logits, pre = _inputs(sum(grid), 4, *grid)
    want, (jg_l, jg_p) = jax.value_and_grad(
        lambda lo, pr: jax_kl(jnp.asarray(pres), lo, pr, prior_prob, 0.8), argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(pre))
    tl = torch.tensor(logits, requires_grad=True)
    tp = torch.tensor(pre, requires_grad=True)
    got = torch_kl(torch.from_numpy(pres), tl, tp, prior_prob, 0.8)
    g_l, g_p = torch.autograd.grad(got, (tl, tp))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_l.numpy(), np.asarray(jg_l), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(jg_p), rtol=1e-5, atol=1e-6)


# ------------------------------------------- the backward kernel's closed form

_jax_value_and_grad = jax.jit(jax.value_and_grad(
    lambda lo, pr, pres, prior: jax_kl(pres, lo, pr, prior, TAU), argnums=(0, 1)))


class _LoopClosedForm(torch.autograd.Function):
    """The loop's totals [B], differentiated by the closed form from the
    loop's prior log-odds, as the kernel pair splits the work."""

    @staticmethod
    def forward(ctx, pres, logits, pre, prior, tau):
        with torch.no_grad():
            totals, log_odds = tops.count_kl_terms(pres, logits, pre, prior, tau)
        ctx.save_for_backward(logits.reshape(totals.shape[0], -1),
                              pre.reshape(totals.shape[0], -1), torch.cat(log_odds, dim=1))
        ctx.tau, ctx.shape = tau, pre.shape
        return totals

    @staticmethod
    def backward(ctx, g_totals):
        logits, pre, log_odds = ctx.saved_tensors
        g_logits, g_pre = tcp.count_kl_backward_reference(logits, pre, log_odds, ctx.tau,
                                                          g_totals)
        return None, g_logits.reshape(ctx.shape), g_pre.reshape(ctx.shape), None, None


def _torch_side(fn, pres, logits, pre, prior):
    tl = torch.tensor(logits, requires_grad=True)
    tp = torch.tensor(pre, requires_grad=True)
    value = fn(torch.from_numpy(pres), tl, tp, prior, TAU)
    return (value.item(),) + tuple(g.numpy() for g in torch.autograd.grad(value, (tl, tp)))


def _closed_form(pres, logits, pre, prior, tau):
    return torch.mean(_LoopClosedForm.apply(pres, logits, pre, prior, tau))


def _hold_three(pres, logits, pre, prior):
    """The closed form against the loop's autograd and the JAX package:
    value, g_logits, g_pre."""
    closed = _torch_side(_closed_form, pres, logits, pre, prior)
    loop = _torch_side(tops.count_kl_loop, pres, logits, pre, prior)
    jprior = np.float32(prior.item() if isinstance(prior, torch.Tensor) else prior)
    value, grads = _jax_value_and_grad(jnp.asarray(logits), jnp.asarray(pre), jnp.asarray(pres),
                                       jprior)
    want = (float(value),) + tuple(np.asarray(g) for g in grads)
    torch.set_flush_denormal(True)
    try:
        flushed = _torch_side(_closed_form, pres, logits, pre, prior)
    finally:
        torch.set_flush_denormal(False)
    for mine, other, side in ((closed, loop, "loop"), (flushed, want, "JAX")):
        for what, a, b in zip(("value", "g_logits", "g_pre"), mine, other):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=f"closed form against the {side}: {what}")
    return closed


@pytest.mark.parametrize("kind", ["float", "tensor"])
@pytest.mark.parametrize("prior_prob", [1e-4, 0.5, 0.99])
@pytest.mark.parametrize("grid", [(1, 1), (4, 4), (6, 6), (3, 2)])
@pytest.mark.parametrize("b", [1, 7, 256])
def test_twin_matches_loop_and_jax(b, grid, prior_prob, kind):
    pres, logits, pre = _inputs(b + 10 * grid[0] + grid[1], b, *grid)
    prior = torch.tensor(prior_prob, dtype=torch.float32) if kind == "tensor" else prior_prob
    value, g_l, g_p = _hold_three(pres, logits, pre, prior)
    assert np.isfinite(value) and np.isfinite(g_l).all() and np.isfinite(g_p).all()


@pytest.mark.parametrize("case", ["logits_at_10", "posterior_exp_overflows",
                                  "prior_exp_overflows"])
def test_twin_at_the_extremes(case):
    """Logits at +-10 exactly; exp(-y tau + lo) past float32's range on the
    posterior's side (lo 60, y -60) or the prior's (y -120): an infinite KL
    and NaN gradients where the loop's autograd gives them."""
    pres, logits, pre = _inputs(3, 7, 4, 4)
    if case == "logits_at_10":
        logits = np.where(np.arange(logits.size).reshape(logits.shape) % 2, 10.0,
                          -10.0).astype(np.float32)
    else:
        logits[:, 1:] = 60.0 if case == "posterior_exp_overflows" else -50.0
        pre[:, 1:] = -60.0 if case == "posterior_exp_overflows" else -120.0
        pres = (1.0 / (1.0 + np.exp(-pre.astype(np.float64)))).astype(np.float32)
    value, g_l, g_p = _hold_three(pres, logits, pre, 0.5)
    if case == "logits_at_10":
        assert np.isfinite(value) and np.isfinite(g_l).all() and np.isfinite(g_p).all()
    else:
        assert np.isinf(value) and np.isnan(g_p[:, 1:]).all()
        assert np.isfinite(g_p[:, 0]).all() and np.isfinite(g_l[:, 0]).all()


def test_twin_backward_is_the_forwards_gradient():
    """The closed form against finite differences of the loop, in float64."""
    pres, logits, pre = (torch.tensor(a, dtype=torch.float64) for a in _inputs(5, 3, 3, 2))
    logits.requires_grad_(True)
    pre.requires_grad_(True)
    torch.autograd.gradcheck(lambda lo, pr: _LoopClosedForm.apply(pres, lo, pr, 0.7, TAU),
                             (logits, pre))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_other_dtypes_take_the_loop(dtype, monkeypatch):
    """CPU tensors, float32 or float64, run the loop: the kernels' Function is
    not called and no kernel is counted."""
    pres, logits, pre = (torch.tensor(a, dtype=dtype) for a in _inputs(2, 5, 4, 4))
    want = tops.count_kl_loop(pres, logits, pre, 0.5, TAU)
    launches = tracing.counters()

    def refuse(*args):
        raise AssertionError("the kernels' Function was called")

    monkeypatch.setattr(tcp.CountPriorKL, "apply", refuse)
    logits.requires_grad_(True)
    got = torch_kl(pres, logits, pre, torch.tensor(0.5, dtype=dtype), TAU)
    got.backward()
    assert got.dtype == dtype and torch.equal(got.detach(), want)
    assert tracing.counters() == launches


def test_entry_points_refuse_what_they_cannot_take():
    pres, logits, pre = (torch.from_numpy(a) for a in _inputs(1, 2, 4, 4))
    with pytest.raises(ValueError, match="z_pres_logits"):
        tcp.count_kl_totals(pres, logits[:, :3], pre, 0.5, TAU)
    with pytest.raises(ValueError, match="prior_prob"):
        tcp.count_kl_totals(pres, logits, pre, torch.tensor([0.5, 0.5]), TAU)
    with pytest.raises(ValueError, match="CUDA"):  # the kernels take no CPU tensor
        tcp.count_kl_totals(pres, logits, pre, 0.5, TAU)
    flat = [t.reshape(2, 16) for t in (pres, logits, pre)]
    with pytest.raises(ValueError, match="CUDA"):
        tcp._fwd(*flat, 0.5, TAU)
    with pytest.raises(ValueError, match="CUDA"):
        tcp._bwd(flat[1], flat[2], flat[2], torch.ones(2), TAU)
