"""split_vae_torch.ops.count_prior against split_vae_tpu.ops.count_prior.

Values and the gradients with respect to the logits and the pre-sigmoid
sample (z_pres enters only through its > 0.5 threshold); rtol 1e-5, atol 1e-6.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.ops.count_prior import z_pres_count_kl as torch_kl  # noqa: E402
from split_vae_tpu.ops.count_prior import z_pres_count_kl as jax_kl  # noqa: E402


def _inputs(seed, b, gh, gw):
    rng = np.random.RandomState(seed)
    logits = rng.uniform(-10, 10, (b, gh, gw, 1)).astype(np.float32)
    u = rng.uniform(0.01, 0.99, logits.shape).astype(np.float32)
    pre = ((logits + np.log(u) - np.log(1 - u)) / 0.8).astype(np.float32)
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
