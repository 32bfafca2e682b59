"""The fused render's plain version (split_vae_torch.kernels.render) against
the JAX package's Pallas kernels (interpret mode) and unfused render.

Tolerances are the TPU tests': forward atol 3e-5 (test_render_fused.py:53),
gradients rtol 1e-3, atol 2e-4 (test_render_packed.py:58-59). The CUDA
kernels themselves are held to this plain version on the card by
chip_smoke.py.

Known tie: at noise 0 the paste is exactly 0 outside each object's box, where
``jnp.clip`` passes half the gradient and the kernels (and the plain version)
none. There alpha is clipped up from 0 to 1e-8, so the pixel's importance is
1e-8 * z_pres * depth_w and the gradient it would carry is below 1e-7.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.kernels import render as tr  # noqa: E402
from split_vae_torch.ops import stn as tstn  # noqa: E402
from split_vae_tpu.nn.spair_nets import render as jax_render  # noqa: E402
from split_vae_tpu.ops.pallas.render_fused import fused_paste_render  # noqa: E402
from split_vae_tpu.ops.pallas.render_packed import fused_paste_render_packed  # noqa: E402
from split_vae_tpu.ops.stn import paste_interp_weights, stn_paste  # noqa: E402

FWD_ATOL = 3e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 2e-4

# (B, grid, object size, canvas, C): the config-#5 48/32 shapes, and one
# shape that is not a multiple of 8.
SHAPES = {"aligned": (2, 4, 32, 48, 3), "unaligned": (2, 3, 30, 45, 3)}


def _inputs(shape, seed=0):
    b, g, os_, s, c = shape
    k = g * g
    rng = np.random.RandomState(seed)
    objs = rng.rand(b, k, os_, os_, c + 1).astype(np.float32)
    z_where = rng.randn(b, g, g, 4).astype(np.float32)
    z_pres = rng.rand(b, k).astype(np.float32)
    depth_w = (1.0 / (1.0 + np.exp(rng.randn(b, k))) + 0.5).astype(np.float32)
    bg = rng.rand(b, s, s, c).astype(np.float32)
    return objs, z_where, z_pres, depth_w, bg


def _weights(z_where, shape):
    _, _, os_, s, _ = shape
    wy, wx, _ = paste_interp_weights(jnp.asarray(z_where), (s, s), (os_, os_))
    return np.array(wy), np.array(wx)


def _oracle(objs, z_where, z_pres, depth_w, bg, s, c):
    """tests/test_render_fused.py::_oracle at any shape: stn_paste, then the composite."""
    full, _ = stn_paste(objs, z_where, (s, s))
    rgb = jnp.clip(full[..., :c], 0.0, 1.0)
    alpha = jnp.clip(full[..., c:], 1e-8, 1.0)
    zp = z_pres[:, :, None, None, None]
    wd = depth_w[:, :, None, None, None]
    imp = zp * alpha * wd
    s1 = jnp.sum(imp * rgb, axis=1)
    s2 = jnp.sum(imp, axis=1)
    s3 = jnp.sum(zp * alpha * imp, axis=1)
    d = s2 + 1e-8
    return (s3 / d) * (s1 / d) + (1.0 - s3 / d) * bg


def _jax_kernel(shape):
    """The Pallas kernel the JAX package takes at this shape, in interpret mode."""
    _, _, os_, s, _ = shape
    fn = fused_paste_render_packed if (os_ % 8 == 0 and s % 8 == 0) else fused_paste_render
    return lambda o, wy, wx, zp, wd, bg: fn(o, wy, wx, zp, wd, bg, jnp.int32(0), 0.0, True)


def _torch_grads(fn, arrays, cot):
    tin = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*tin)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), tin)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_render_matches_pallas_kernel(name):
    shape = SHAPES[name]
    objs, z_where, z_pres, depth_w, bg = _inputs(shape, 1)
    wy, wx = _weights(z_where, shape)
    arrays = [objs, wy, wx, z_pres, depth_w, bg]
    kernel = _jax_kernel(shape)
    want = np.asarray(kernel(*map(jnp.asarray, arrays)))
    cot = np.random.RandomState(9).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(kernel(*a) * cot), argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays))
    got, tg = _torch_grads(tr.render_reference, arrays, cot)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    for n, a, b in zip(("objs", "wy", "wx", "z_pres", "depth_w", "bg"), tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"gradient of {n}")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fused_path_matches_oracle_through_z_where(name):
    """Weights from z_where in each package, then render: the JAX oracle
    (stn_paste + composite) against the port's wrapper on CPU tensors."""
    shape = SHAPES[name]
    _, _, os_, s, c = shape
    objs, z_where, z_pres, depth_w, bg = _inputs(shape, 2)
    arrays = [objs, z_where, z_pres, depth_w, bg]
    want = np.asarray(_oracle(*map(jnp.asarray, arrays), s, c))
    cot = np.random.RandomState(3).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(_oracle(*a, s, c) * cot), argnums=tuple(range(5)))(
        *map(jnp.asarray, arrays))

    def port(o, zw, zp, wd, b):
        wy, wx, _ = tstn.paste_interp_weights(zw, (s, s), (os_, os_))
        return tr.fused_paste_render(o, wy, wx, zp, wd, b, torch.zeros(1, dtype=torch.int32),
                                     0.0)

    got, tg = _torch_grads(port, arrays, cot)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    for n, a, b in zip(("objs", "z_where", "z_pres", "depth_w", "bg"), tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"gradient of {n}")


def test_plain_render_with_noise_matches_jax_unfused_render():
    """Given the same N(0, 1) field, the plain version (noise 0.01) equals the
    JAX package's training-branch render."""
    shape = SHAPES["aligned"]
    b, g, _, s, c = shape
    objs, z_where, z_pres, depth_w, bg = _inputs(shape, 4)
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (b, g * g, s, s, c), dtype=jnp.float32))
    z_depth = -np.log(1.0 / (depth_w - 0.5) - 1.0).astype(np.float32)

    def jax_fn(o, zw, zp, zd, bgi):
        full, _ = stn_paste(o, zw, (s, s))
        return jax_render(full, bgi, zd.reshape(b, g, g, 1), zp.reshape(b, g, g, 1), None, key,
                          training=True, num_channel=c)

    arrays = [objs, z_where, z_pres, z_depth, bg]
    want = np.asarray(jax_fn(*map(jnp.asarray, arrays)))
    cot = np.random.RandomState(5).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * cot), argnums=tuple(range(5)))(
        *map(jnp.asarray, arrays))
    noise = 0.01 * torch.from_numpy(eps).permute(0, 1, 4, 2, 3)

    def port(o, zw, zp, zd, bgi):
        wy, wx, _ = tstn.paste_interp_weights(zw, (s, s), (o.shape[2], o.shape[3]))
        return tr.render_reference(o, wy, wx, zp, torch.sigmoid(-zd) + 0.5, bgi, noise)

    got, tg = _torch_grads(port, arrays, cot)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    for n, a, bb in zip(("objs", "z_where", "z_pres", "z_depth", "bg"), tg, jg):
        np.testing.assert_allclose(a, np.asarray(bb), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"gradient of {n}")


def test_render_noise_is_a_seeded_standard_normal_field():
    seed = torch.tensor([12345], dtype=torch.int32)
    a = tr.render_noise(seed, 2, 3, 3, 16, 16)
    assert a.shape == (2, 3, 3, 16, 16) and a.dtype == torch.float32
    assert torch.equal(a, tr.render_noise(seed, 2, 3, 3, 16, 16))
    assert not torch.equal(a, tr.render_noise(seed + 1, 2, 3, 3, 16, 16))
    # Image b is keyed seed + b: image 1 of seed s is image 0 of seed s + 1.
    assert torch.equal(a[1], tr.render_noise(seed + 1, 1, 3, 3, 16, 16)[0])
    assert abs(a.mean().item()) < 0.05 and abs(a.std().item() - 1.0) < 0.05


def test_render_noise_is_philox_4x32_10():
    """Key 0, counter 0: the Random123 known answer for Philox-4x32-10 is the
    words 6627e8d5 e169c58d ...; the field is Box-Muller on the first two."""
    u1 = (0x6627E8D5 + 0.5) * 2.0**-32
    u2 = (0xE169C58D + 0.5) * 2.0**-32
    want = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    got = tr.render_noise(torch.zeros(1, dtype=torch.int32), 1, 1, 1, 1, 1)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_cpu_wrapper_adds_the_seeded_noise_and_launches_nothing():
    shape = SHAPES["unaligned"]
    b, g, os_, s, c = shape
    objs, z_where, z_pres, depth_w, bg = (torch.from_numpy(a) for a in _inputs(shape, 6))
    wy, wx, _ = tstn.paste_interp_weights(z_where, (s, s), (os_, os_))
    seed = torch.tensor([77], dtype=torch.int32)
    before = (tr.fwd_launches, tr.bwd_launches)
    got = tr.fused_paste_render(objs, wy, wx, z_pres, depth_w, bg, seed, 0.01)
    want = tr.render_reference(objs, wy, wx, z_pres, depth_w, bg,
                               0.01 * tr.render_noise(seed, b, g * g, c, s, s))
    assert torch.equal(got, want)
    assert not torch.equal(got, tr.render_reference(objs, wy, wx, z_pres, depth_w, bg))
    assert (tr.fwd_launches, tr.bwd_launches) == before


def test_clip_strict_passes_gradient_only_inside():
    x = torch.tensor([-0.5, 0.0, 0.5, 1.0, 1.5], requires_grad=True)
    y = tr.clip_strict(x, 0.0, 1.0)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(y.detach(), torch.tensor([0.0, 0.0, 0.5, 1.0, 1.0]))
    assert torch.equal(g, torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0]))
