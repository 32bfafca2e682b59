"""split_vae_torch.ops.distributions against split_vae_tpu.ops.distributions.

The same seeded numpy inputs, and the same noise, go through both packages;
values and gradients agree at rtol 1e-5, atol 1e-6 (both fp32 on the CPU).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.ops import distributions as td  # noqa: E402
from split_vae_tpu.ops import distributions as jd  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _grads_match(jax_fn, torch_fn, arrays, seed=0):
    """Value of f and d<f, w>/d(inputs) for a random cotangent w, both packages."""
    want_val = jax_fn(*[jnp.asarray(a) for a in arrays])
    w = np.asarray(np.random.RandomState(seed + 100).randn(*np.shape(want_val)), np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * w), argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    tin = [torch.tensor(a, requires_grad=True) for a in arrays]
    got_val = torch_fn(*tin)
    tg = torch.autograd.grad(torch.sum(got_val * torch.from_numpy(w)), tin)
    _close(got_val.detach(), want_val, "value")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, f"gradient of input {i}")


def _rand(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_reparameterize_with_given_eps():
    rng = np.random.RandomState(0)
    key = jax.random.PRNGKey(3)
    mean, sigma = _rand(rng, 4, 8), _rand(rng, 4, 8, lo=0.1, hi=2.0)
    eps = np.array(jax.random.normal(key, sigma.shape, dtype=jnp.float32))
    _grads_match(lambda m, s: jd.reparameterize(key, m, s),
                 lambda m, s: td.reparameterize(m, s, torch.from_numpy(eps)),
                 [mean, sigma])


def test_reparameterize_draws_from_generator():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    mean, sigma = torch.zeros(3, 4), torch.ones(3, 4)
    a = td.reparameterize(mean, sigma, generator=g1)
    b = td.reparameterize(mean, sigma, generator=g2)
    assert torch.equal(a, b) and a.std() > 0


def test_concrete_binary_pre_sigmoid_sample():
    rng = np.random.RandomState(1)
    key = jax.random.PRNGKey(4)
    logits = _rand(rng, 4, 2, 2, 1, lo=-10, hi=10)
    u = np.array(jax.random.uniform(key, logits.shape, dtype=jnp.float32))
    _grads_match(lambda lo: jd.concrete_binary_pre_sigmoid_sample(key, lo, 0.8),
                 lambda lo: td.concrete_binary_pre_sigmoid_sample(lo, 0.8, torch.from_numpy(u)),
                 [logits])


def test_concrete_binary_sample_kl():
    rng = np.random.RandomState(2)
    y, prior, post = _rand(rng, 4, 1, lo=-5, hi=5), _rand(rng, 4, 1, lo=-3, hi=3), \
        _rand(rng, 4, 1, lo=-3, hi=3)
    _grads_match(lambda a, b, c: jd.concrete_binary_sample_kl(a, b, 0.8, c, 0.8),
                 lambda a, b, c: td.concrete_binary_sample_kl(a, b, 0.8, c, 0.8),
                 [y, prior, post])


def test_gaussian_kl_safe():
    rng = np.random.RandomState(3)
    _grads_match(jd.gaussian_kl_safe, td.gaussian_kl_safe,
                 [_rand(rng, 4, 2, 2, 8), _rand(rng, 4, 2, 2, 8, lo=0.05, hi=2.0)])


@pytest.mark.parametrize("mean2,sig2", [(10.0, 0.5), (0.0, 1.0)])
def test_gaussian_kl_two_safe(mean2, sig2):
    rng = np.random.RandomState(4)
    _grads_match(lambda m, s: jd.gaussian_kl_two_safe(m, s, mean2, sig2),
                 lambda m, s: td.gaussian_kl_two_safe(m, s, mean2, sig2),
                 [_rand(rng, 4, 2, 2, 2), _rand(rng, 4, 2, 2, 2, lo=0.05, hi=2.0)])


def test_mean_sum():
    rng = np.random.RandomState(5)
    _grads_match(jd.mean_sum, td.mean_sum, [_rand(rng, 3, 5, 4)])


def test_bernoulli_xent():
    rng = np.random.RandomState(6)
    label = _rand(rng, 3, 6, 6, 3, lo=0.0, hi=1.0)
    pred = _rand(rng, 3, 6, 6, 3, lo=0.01, hi=0.99)
    _grads_match(jd.bernoulli_xent, td.bernoulli_xent, [label, pred])


@pytest.mark.parametrize("value", [1.0, 0.0, -1e-8, 0.5, -1.0])
def test_safe_log_at_edges(value):
    """log(value + 1e-8), -100 where that is not finite, and a gradient that
    is zero on the replaced branch and finite at pred == 1 (1 - pred == 0)."""
    x = np.asarray([value, 0.25], np.float32)
    _grads_match(jd.safe_log, td.safe_log, [x])
    t = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(td.safe_log(t).sum(), t)
    assert torch.isfinite(g).all()


def test_bernoulli_xent_at_pred_one():
    label = np.asarray([[1.0, 0.0, 0.5]], np.float32)
    pred = np.asarray([[1.0, 1.0, 1.0]], np.float32)
    _grads_match(jd.bernoulli_xent, td.bernoulli_xent, [label, pred])
