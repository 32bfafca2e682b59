"""split_vae_torch.ops.patches against split_vae_tpu.ops.patches (scramble).

The permutation is the argsort of per-image uniforms (patches.py:75); the
test draws those uniforms with the JAX key and hands them to the port.
Values and gradients agree at rtol 1e-5, atol 1e-6.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.ops import patches as tp  # noqa: E402
from split_vae_tpu.ops import patches as jp  # noqa: E402


@pytest.mark.parametrize("shape,size", [((3, 24, 24, 3), 8), ((2, 48, 48, 3), 8),
                                        ((2, 16, 16, 3), 4), ((2, 8, 8, 3), 1)])
def test_augment_scramble_matches(shape, size):
    rng = np.random.RandomState(size)
    x = rng.rand(*shape).astype(np.float32)
    key = jax.random.PRNGKey(size + 11)
    u = np.array(jax.random.uniform(key, tp.scramble_shape(shape, size)))
    w = rng.randn(shape[0], shape[1], shape[2], 2 * shape[3]).astype(np.float32)

    want, jg = jax.value_and_grad(
        lambda a: jnp.sum(jp.augment_batch(key, a, "scramble", size) * w))(jnp.asarray(x))
    want_img = jp.augment_batch(key, jnp.asarray(x), "scramble", size)

    tx = torch.tensor(x, requires_grad=True)
    got_img = tp.augment_batch(tx, "scramble", size, u=torch.from_numpy(u))
    (g,) = torch.autograd.grad(torch.sum(got_img * torch.from_numpy(w)), tx)
    np.testing.assert_allclose(got_img.detach().numpy(), np.asarray(want_img), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_scramble_is_a_permutation_of_patches():
    x = torch.arange(2 * 8 * 8 * 1, dtype=torch.float32).reshape(2, 8, 8, 1)
    out = tp.batched_scramble(x, 4, generator=torch.Generator().manual_seed(0))
    for b in range(2):
        assert sorted(out[b].flatten().tolist()) == sorted(x[b].flatten().tolist())


def test_no_op_and_unported_kinds():
    """no_op passes the batch through; every kind of the JAX package is
    ported, so only an unknown kind raises, as it does there."""
    x = torch.zeros(1, 8, 8, 3)
    assert tp.augment_batch(x, "no_op") is x
    with pytest.raises(ValueError, match="Unknown augmentation"):
        tp.augment_batch(x, "sharpen")
    with pytest.raises(ValueError, match="Unknown augmentation"):
        jp.augment_batch(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), "sharpen")


@pytest.mark.parametrize("kind,channels", [("mix_scramble", 6), ("blur", 6),
                                           ("high_low_pass", 9)])
def test_ported_kinds_run_from_a_generator(kind, channels):
    """The kinds that used to raise: shapes as the JAX package's, the image
    kept in the first channels, the draws taken from the generator."""
    x = torch.from_numpy(np.random.RandomState(0).rand(3, 16, 16, 3).astype(np.float32))
    out = tp.augment_batch(x, kind, 2, generator=torch.Generator().manual_seed(1))
    want = jp.augment_batch(jax.random.PRNGKey(0), jnp.asarray(x.numpy()), kind, 2)
    assert tuple(out.shape) == tuple(want.shape) == (3, 16, 16, channels)
    assert torch.equal(out[..., :3], x)
    assert torch.isfinite(out).all()
    if kind != "high_low_pass":
        with pytest.raises(ValueError, match="generator"):
            tp.augment_batch(x, kind, 2)
