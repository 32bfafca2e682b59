"""The LGVae slice's new functions of split_vae_torch.ops.distributions and
split_vae_torch.ops.patches against their JAX counterparts.

The same seeded numpy inputs, and the same draws (made with the JAX keys and
handed to the port), go through both packages; values and gradients agree at
rtol 1e-5, atol 1e-5 (fp32 on the CPU; the blurs' sums of 13 and 2*size + 1
taps run in another order).
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.ops import distributions as td  # noqa: E402
from split_vae_torch.ops import patches as tp  # noqa: E402
from split_vae_tpu.ops import distributions as jd  # noqa: E402
from split_vae_tpu.ops import patches as jp  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _grads_match(jax_fn, torch_fn, arrays, seed=0, grad_rtol=RTOL, grad_atol=ATOL):
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
        assert torch.isfinite(a).all(), f"gradient of input {i} is not finite"
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=grad_rtol, atol=grad_atol,
                                   err_msg=f"gradient of input {i}")


def _rand(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


# ---------------------------------------------------------------- distributions


def test_gaussian_kl():
    rng = np.random.RandomState(0)
    _grads_match(jd.gaussian_kl, td.gaussian_kl,
                 [_rand(rng, 4, 8), _rand(rng, 4, 8, lo=0.05, hi=2.0)])


@pytest.mark.parametrize("prior", ["tensors", "scalars"])
def test_gaussian_kl_two(prior):
    rng = np.random.RandomState(1)
    m1, s1 = _rand(rng, 4, 6), _rand(rng, 4, 6, lo=0.1, hi=2.0)
    if prior == "tensors":
        _grads_match(jd.gaussian_kl_two, td.gaussian_kl_two,
                     [m1, s1, _rand(rng, 4, 6), _rand(rng, 4, 6, lo=0.2, hi=1.5)])
    else:
        _grads_match(lambda m, s: jd.gaussian_kl_two(m, s, 0.0, 1.0),
                     lambda m, s: td.gaussian_kl_two(m, s, 0.0, 1.0), [m1, s1])


def test_discretized_logistic_nll_random():
    """Values at 1e-5. The gradients at rtol 1e-3, atol 1e-4: the bulk branch
    is the log of a difference of two sigmoids, which fp32 holds to about 1e-5
    relative, and its gradient (up to 50 here, at log_scale -4) divides a
    difference of the same kind by it; XLA and torch round the two differently."""
    rng = np.random.RandomState(2)
    x = np.round(_rand(rng, 3, 8, 8, 3) * 127.5) / 127.5
    _grads_match(jd.discretized_logistic_nll, td.discretized_logistic_nll,
                 [x.astype(np.float32), _rand(rng, 3, 8, 8, 3),
                  _rand(rng, 3, 8, 8, 3, lo=-4, hi=1)], grad_rtol=1e-3, grad_atol=1e-4)


# Where the three nested selects meet: both edges, the CDF difference just
# under and over 1e-5 (7% each side: the fp32 difference of two sigmoids near
# 1 is itself good to about 1%), and the extreme scales. Every branch is evaluated at
# every point, so each must keep a finite gradient where it is not taken.
EDGES = {
    "x_at_minus_one": (-1.0, 0.3, -1.0),
    "x_at_plus_one": (1.0, -0.2, -1.0),
    "x_just_inside_edges": (0.998, 0.1, -2.0),
    "cdf_delta_just_under_1e-5": (0.5, 0.5 - 8.74 * math.exp(-2.0), -2.0),
    "cdf_delta_just_over_1e-5": (0.5, 0.5 - 8.60 * math.exp(-2.0), -2.0),
    "cdf_delta_underflows": (0.9, -0.9, -7.0),
    "log_scale_minus_7_at_mean": (0.25, 0.25, -7.0),
    "log_scale_plus_3": (-0.4, 0.6, 3.0),
    "log_scale_plus_3_at_edge": (1.0, 0.0, 3.0),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_discretized_logistic_nll_edges(case):
    x, mean, log_scale = (np.full((1, 1, 1, 2), v, np.float32) for v in EDGES[case])
    if case.startswith("cdf_delta_just"):
        inv = np.exp(-log_scale[0, 0, 0, 0])
        sig = lambda v: 1.0 / (1.0 + np.exp(-v))
        delta = (sig(inv * (x - mean + 1 / 255.0)) - sig(inv * (x - mean - 1 / 255.0)))[0, 0, 0, 0]
        assert (delta < 1e-5) == ("under" in case) and 0.85e-5 < delta < 1.15e-5, delta
    _grads_match(jd.discretized_logistic_nll, td.discretized_logistic_nll, [x, mean, log_scale])


def test_categorical_kl_uniform():
    rng = np.random.RandomState(3)
    _grads_match(lambda lg: jd.categorical_kl_uniform(lg, 30),
                 lambda lg: td.categorical_kl_uniform(lg, 30), [_rand(rng, 5, 30, lo=-3, hi=3)])


def test_gumbel_softmax_with_given_uniforms():
    rng = np.random.RandomState(4)
    key = jax.random.PRNGKey(8)
    logits = _rand(rng, 4, 10, lo=-2, hi=2)
    u = np.array(jax.random.uniform(key, logits.shape, dtype=jnp.float32))
    _grads_match(lambda lg: jd.gumbel_softmax(key, lg, 0.4),
                 lambda lg: td.gumbel_softmax(lg, 0.4, u=torch.from_numpy(u)), [logits])
    a = td.gumbel_softmax(torch.from_numpy(logits), 0.4,
                          generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------- patches


def _mix_draws(key, shape):
    """The draws of jp.batched_mix_scramble, made with its own keys."""
    k_size, *k_perms = jax.random.split(key, 1 + len(jp.MIX_SIZES))
    idx = np.array(jax.random.randint(k_size, (shape[0],), 0, len(jp.MIX_SIZES)))
    us = [np.array(jax.random.uniform(kp, tp.scramble_shape(shape, s)))
          for kp, s in zip(k_perms, jp.MIX_SIZES)]
    return idx, us


def _blur_draws(key, b):
    """The draws of jax.vmap(jp.gaussian_blur), made with its own keys."""
    std, half = [], []
    for k in jax.random.split(key, b):
        k_std, k_size = jax.random.split(k)
        std.append(float(jax.random.uniform(k_std, (), dtype=jnp.float32, minval=5.0,
                                            maxval=10.0)))
        half.append(int(jax.random.randint(k_size, (), 3, 7)))
    return np.array(std, np.float32), np.array(half)


def _augment_matches(kind, shape, size, u, key, channels):
    rng = np.random.RandomState(7)
    x = rng.rand(*shape).astype(np.float32)
    w = rng.randn(*shape[:3], channels).astype(np.float32)
    want = jp.augment_batch(key, jnp.asarray(x), kind, size)
    jg = jax.grad(lambda a: jnp.sum(jp.augment_batch(key, a, kind, size) * w))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = tp.augment_batch(tx, kind, size, u=u)
    (g,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)), tx)
    assert got.shape[-1] == channels == tp.augmented_channels(kind, shape[-1])
    assert jp.augmented_channels(kind, shape[-1]) == channels
    _close(got.detach(), want, kind)
    _close(g, jg, f"gradient through {kind}")


@pytest.mark.parametrize("shape", [(6, 16, 16, 3), (5, 32, 32, 3)])
def test_augment_mix_scramble_matches(shape):
    key = jax.random.PRNGKey(21)
    idx, us = _mix_draws(key, shape)
    assert len(set(idx.tolist())) > 1, "the draw should mix patch sizes"
    u = (torch.from_numpy(idx), [torch.from_numpy(a) for a in us])
    _augment_matches("mix_scramble", shape, 1, u, key, 6)


@pytest.mark.parametrize("shape", [(4, 16, 16, 3), (3, 32, 24, 3)])
def test_augment_blur_matches(shape):
    key = jax.random.PRNGKey(22)
    std, half = _blur_draws(key, shape[0])
    _augment_matches("blur", shape, 1, (torch.from_numpy(std), torch.from_numpy(half)), key, 6)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_augment_high_low_pass_matches(size):
    _augment_matches("high_low_pass", (3, 16, 20, 3), size, None, jax.random.PRNGKey(0), 9)


def test_high_low_pass_parts_sum_to_the_image():
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 12, 12, 3).astype(np.float32))
    high, low = tp.high_low_pass(x, 3)
    np.testing.assert_allclose((high + low).numpy(), x.numpy(), atol=1e-6)
    const = torch.full((1, 9, 9, 3), 0.7)
    np.testing.assert_allclose(tp.high_low_pass(const, 2)[1].numpy(), 0.7, atol=1e-6)


@pytest.mark.parametrize("kind", ["scramble", "mix_scramble", "blur", "high_low_pass", "no_op"])
def test_augment_draws_feed_augment_batch(kind):
    """Draws from a generator have the shapes and ranges the kind wants, and a
    replayed list gives the same view again."""
    x = torch.from_numpy(np.random.RandomState(2).rand(4, 16, 16, 3).astype(np.float32))
    u = tp.augment_draws(kind, x.shape, 4, Noise(torch.Generator().manual_seed(3)))
    out = tp.augment_batch(x, kind, 4, u=u)
    assert out.shape == (4, 16, 16, tp.augmented_channels(kind))
    again = tp.augment_batch(x, kind, 4, generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    if kind == "blur":
        std, half = u
        assert ((std >= 5) & (std < 10)).all() and ((half >= 3) & (half <= 6)).all()
    if kind == "mix_scramble":
        idx, us = u
        assert ((idx >= 0) & (idx < 4)).all()
        assert [tuple(a.shape) for a in us] == [(4, 256), (4, 64), (4, 16), (4, 4)]
        replayed = tp.augment_draws(kind, x.shape, 4, Noise(torch.Generator(),
                                                            [idx.float()] + list(us)))
        assert torch.equal(tp.augment_batch(x, kind, 4, u=replayed), out)
