"""The fused render's plain versions (split_vae_torch.kernels.render) against
the JAX package's Pallas kernels (interpret mode) and unfused render; at 2 and
4 colour channels also the row-windowed wrapper's, and both pairs' shape
checks for every channel count up to MAX_CHANNELS.

The port's render takes the paste's sample coordinates ys, xs in place of
the dense weights wy, wx: ``render_taps_reference`` (the dense weights from
the coordinates, then ``render_reference``) is held against the Pallas
kernels fed with the JAX weights, through z_where; the gradient formulas of
the coordinates that the CUDA backward implements are held against autograd
through the dense weights.

Tolerances are the TPU tests': forward atol 3e-5 (test_render_fused.py:53),
gradients rtol 1e-3, atol 2e-4 (test_render_packed.py:58-59). The CUDA
kernels themselves are held to this plain version on the card by
chip_smoke.py.

Known tie: at noise 0 the paste is exactly 0 outside each object's box, where
``jnp.clip`` passes half the gradient and the kernels (and the plain version)
none. There alpha is clipped up from 0 to 1e-8, so the pixel's importance is
1e-8 * z_pres * depth_w and the gradient it would carry is below 1e-7.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.core import tracing  # noqa: E402
from split_vae_torch.kernels import render as tr  # noqa: E402
from split_vae_torch.kernels import render_windowed as tw  # noqa: E402
from split_vae_torch.ops import stn as tstn  # noqa: E402
from split_vae_tpu.nn.spair_nets import render as jax_render  # noqa: E402
from split_vae_tpu.ops.pallas.render_fused import fused_paste_render  # noqa: E402
from split_vae_tpu.ops.pallas.render_packed import fused_paste_render_packed  # noqa: E402
from split_vae_tpu.ops.stn import _interp_matrix as jax_interp_matrix  # noqa: E402
from split_vae_tpu.ops.stn import _sample_coords as jax_sample_coords  # noqa: E402
from split_vae_tpu.ops.stn import paste_interp_weights, stn_paste  # noqa: E402
from split_vae_tpu.ops.stn import paste_interp_weights_ys as jax_weights_ys  # noqa: E402
from split_vae_tpu.ops.stn import zwhere_to_params as jax_zwhere_to_params  # noqa: E402

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
        ys, xs, _ = tstn.paste_sample_coords(zw, (s, s), (os_, os_))
        return tr.fused_paste_render(o, ys, xs, zp, wd, b, torch.zeros(1, dtype=torch.int32),
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
        ys, xs, _ = tstn.paste_sample_coords(zw, (s, s), (o.shape[2], o.shape[3]))
        return tr.render_taps_reference(o, ys, xs, zp, torch.sigmoid(-zd) + 0.5, bgi, noise)

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
    ys, xs, _ = tstn.paste_sample_coords(z_where, (s, s), (os_, os_))
    seed = torch.tensor([77], dtype=torch.int32)
    before = tracing.counters()
    got = tr.fused_paste_render(objs, ys, xs, z_pres, depth_w, bg, seed, 0.01)
    want = tr.render_taps_reference(objs, ys, xs, z_pres, depth_w, bg,
                                    0.01 * tr.render_noise(seed, b, g * g, c, s, s))
    assert torch.equal(got, want)
    assert not torch.equal(got, tr.render_taps_reference(objs, ys, xs, z_pres, depth_w, bg))
    assert tracing.counters() == before


def test_clip_strict_passes_gradient_only_inside():
    x = torch.tensor([-0.5, 0.0, 0.5, 1.0, 1.5], requires_grad=True)
    y = tr.clip_strict(x, 0.0, 1.0)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(y.detach(), torch.tensor([0.0, 0.0, 0.5, 1.0, 1.0]))
    assert torch.equal(g, torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0]))


def _jax_coords(z_where, os_, s):
    """The JAX package's paste coordinates: ys from paste_interp_weights_ys,
    xs from zwhere_to_params and _sample_coords, as its paste computes them."""
    _, _, _, ys = jax_weights_ys(jnp.asarray(z_where), (s, s), (os_, os_))
    sx, _, tx, _ = jax_zwhere_to_params(jnp.asarray(z_where))
    return np.asarray(ys), np.asarray(jax_sample_coords(1.0 / (sx + 1e-5), -tx / (sx + 1e-5),
                                                         s, os_))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_taps_render_matches_pallas_kernel_through_z_where(name):
    """The Pallas kernel fed with the JAX weights of z_where against
    ``render_taps_reference`` fed with the port's coordinates of the same
    z_where: forward and the gradients of objs, z_where, z_pres, depth_w, bg."""
    shape = SHAPES[name]
    _, _, os_, s, _ = shape
    objs, z_where, z_pres, depth_w, bg = _inputs(shape, 11)
    arrays = [objs, z_where, z_pres, depth_w, bg]
    kernel = _jax_kernel(shape)

    def jax_fn(o, zw, zp, wd, b):
        wy, wx, _ = paste_interp_weights(zw, (s, s), (os_, os_))
        return kernel(o, wy, wx, zp, wd, b)

    want = np.asarray(jax_fn(*map(jnp.asarray, arrays)))
    cot = np.random.RandomState(12).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * cot), argnums=tuple(range(5)))(
        *map(jnp.asarray, arrays))

    def port(o, zw, zp, wd, b):
        ys, xs, _ = tstn.paste_sample_coords(zw, (s, s), (os_, os_))
        return tr.render_taps_reference(o, ys, xs, zp, wd, b)

    got, tg = _torch_grads(port, arrays, cot)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    for n, a, b in zip(("objs", "z_where", "z_pres", "depth_w", "bg"), tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"gradient of {n}")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_taps_render_matches_pallas_kernel_at_saturated_boxes(name):
    """z_where x10: most boxes saturate, coordinates reach 1e5 px and beyond
    and many rows and columns fall outside the object. Both sides take the
    JAX package's coordinates (the Pallas kernel their dense weights), so the
    render alone is held: forward and the gradients of objs, ys, xs, z_pres,
    depth_w, bg. Through z_where the two packages' coordinates differ there
    by the STN's own rounding (ROADMAP C): a coordinate is the difference of
    two terms of 1e3 px and more, and an ulp of those moves the paste by
    1e-4."""
    shape = SHAPES[name]
    _, _, os_, s, _ = shape
    objs, z_where, z_pres, depth_w, bg = _inputs(shape, 11)
    ys, xs = _jax_coords((10.0 * z_where).astype(np.float32), os_, s)
    assert np.abs(ys).max() > 1e5 and ((ys < 0) | (ys >= os_ - 1)).mean() > 0.3
    arrays = [objs, ys, xs, z_pres, depth_w, bg]
    kernel = _jax_kernel(shape)

    def jax_fn(o, y, x, zp, wd, b):
        return kernel(o, jax_interp_matrix(y, os_), jax_interp_matrix(x, os_), zp, wd, b)

    want = np.asarray(jax_fn(*map(jnp.asarray, arrays)))
    cot = np.random.RandomState(12).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * cot), argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays))
    got, tg = _torch_grads(tr.render_taps_reference, arrays, cot)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    for n, a, b in zip(("objs", "ys", "xs", "z_pres", "depth_w", "bg"), tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"gradient of {n}")


@pytest.mark.parametrize("z_scale", [1.0, 10.0])
def test_paste_sample_coords_match_jax(z_scale):
    """The port's paste coordinates against the JAX package's (``_jax_coords``).

    rtol 1e-5 of each cell's largest coordinate: a coordinate is the sum of
    two terms of that size (1/(s + eps) times the grid, and -t/(s + eps)),
    and XLA's sigmoid and tanh round by an ulp differently from torch's
    (ROADMAP C), so a coordinate near 0 carries its cell's rounding."""
    os_, s = 30, 45
    z_where = (z_scale * np.random.RandomState(13).randn(2, 3, 3, 4)).astype(np.float32)
    want_ys, want_xs = _jax_coords(z_where, os_, s)
    ys, xs, _ = tstn.paste_sample_coords(torch.from_numpy(z_where), (s, s), (os_, os_))
    for got, want in ((ys.numpy(), want_ys), (xs.numpy(), want_xs)):
        scale = np.abs(want).max(axis=-1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-5 * scale), np.abs(got - want).max()


def test_paste_weights_are_built_on_the_sample_coordinates():
    z_where = torch.from_numpy(np.random.RandomState(14).randn(2, 3, 3, 4).astype(np.float32))
    wy, wx, bbox, ys0 = tstn.paste_interp_weights_ys(z_where, (45, 45), (30, 30))
    ys, xs, bbox2 = tstn.paste_sample_coords(z_where, (45, 45), (30, 30))
    assert torch.equal(ys, ys0) and torch.equal(bbox, bbox2)
    assert torch.equal(wy, tr.interp_matrix(ys, 30)) and torch.equal(wx, tr.interp_matrix(xs, 30))


def _taps(u, n):
    """csrc/render.cu::make_tap in torch: indices and weights, 0 where the
    clamped taps coincide."""
    x0 = torch.floor(u)
    i0 = torch.clamp(x0, 0.0, n - 1.0)
    i1 = torch.clamp(x0 + 1.0, 0.0, n - 1.0)
    apart = i0 != i1
    zero = torch.zeros_like(u)
    return (i0.long(), i1.long(), torch.where(apart, i1 - u, zero),
            torch.where(apart, u - i0, zero))


def _edge_coords(rng, shape, n):
    """Random coordinates with edge values mixed in: integers, n-1, (-1, 0),
    (n-1, n), and far outside."""
    u = rng.uniform(-3.0, n + 2.0, shape)
    edges = np.array([0.0, 1.0, n - 2.0, n - 1.0, -0.5, n - 0.5, -1.0, n, 1e5, -1e5, 7.0])
    flat = u.reshape(-1)
    pick = rng.rand(flat.size) < 0.3
    flat[pick] = rng.choice(edges, pick.sum())
    return torch.from_numpy(flat.reshape(shape).astype(np.float32))


def test_coordinate_gradient_formulas_match_autograd_through_dense_weights():
    """The gradients the CUDA backward forms from the four taps (g_ys, g_xs
    by differences of taps, g_obj as the transpose of the gather), in plain
    torch, against autograd of the dense paste through interp_matrix, at
    random and edge coordinates."""
    rng = np.random.RandomState(15)
    b, k, h, w, hh, ww, c1 = 2, 3, 9, 7, 12, 11, 4
    objs = torch.from_numpy(rng.rand(b, k, h, w, c1).astype(np.float32))
    ys, xs = _edge_coords(rng, (b, k, hh), h), _edge_coords(rng, (b, k, ww), w)
    gp = torch.from_numpy(rng.randn(b, k, hh, ww, c1).astype(np.float32))

    ins = [t.clone().requires_grad_(True) for t in (objs, ys, xs)]
    paste = tr.paste(ins[0], tr.interp_matrix(ins[1], h), tr.interp_matrix(ins[2], w))
    want = torch.autograd.grad(paste, ins, gp)

    iy0, iy1, wy0, wy1 = _taps(ys, h)
    jx0, jx1, wx0, wx1 = _taps(xs, w)
    bi = torch.arange(b)[:, None, None, None]
    ki = torch.arange(k)[None, :, None, None]

    def tap(i, j):  # obj[b, k, i[y], j[x], :] -> [B,K,H,W,C1]
        return objs[bi, ki, i[:, :, :, None], j[:, :, None, :]]

    a, bb, cc, d = tap(iy0, jx0), tap(iy0, jx1), tap(iy1, jx0), tap(iy1, jx1)
    wx0e, wx1e = wx0[:, :, None, :, None], wx1[:, :, None, :, None]
    wy0e, wy1e = wy0[:, :, :, None, None], wy1[:, :, :, None, None]
    g_ys = (gp * (wx0e * (cc - a) + wx1e * (d - bb))).sum(dim=(3, 4))
    g_xs = (gp * (wy0e * (bb - a) + wy1e * (d - cc))).sum(dim=(2, 4))
    g_obj = torch.zeros_like(objs).reshape(b, k, h * w, c1)
    for i, j, wgt in ((iy0, jx0, wy0e * wx0e), (iy0, jx1, wy0e * wx1e), (iy1, jx0, wy1e * wx0e),
                      (iy1, jx1, wy1e * wx1e)):
        idx = (i[:, :, :, None] * w + j[:, :, None, :]).reshape(b, k, hh * ww, 1)
        g_obj.scatter_add_(2, idx.expand(-1, -1, -1, c1), (wgt * gp).reshape(b, k, hh * ww, c1))
    for n, got, ref in (("objs", g_obj.reshape(objs.shape), want[0]), ("ys", g_ys, want[1]),
                        ("xs", g_xs, want[2])):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"gradient of {n}")
    # Rows and columns whose taps coincide carry no gradient.
    assert torch.all(g_ys[iy0 == iy1] == 0) and torch.all(want[1][iy0 == iy1] == 0)
    assert torch.all(g_xs[jx0 == jx1] == 0) and torch.all(want[2][jx0 == jx1] == 0)


def test_kernel_entry_points_take_no_cpu_tensor():
    """The kernel wrappers raise on CPU tensors: only fused_paste_render
    chooses the plain version, and only because its tensors lie on the CPU."""
    shape = SHAPES["unaligned"]
    _, _, os_, s, _ = shape
    objs, z_where, z_pres, depth_w, bg = (torch.from_numpy(a) for a in _inputs(shape, 16))
    ys, xs, _ = tstn.paste_sample_coords(z_where, (s, s), (os_, os_))
    seed = torch.zeros(1, dtype=torch.int32)
    args = (objs, ys, xs, z_pres, depth_w, bg, seed, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        tr._fwd(*args)
    sums = torch.zeros((objs.shape[0], 5, s, s))
    with pytest.raises(ValueError, match="CUDA"):
        tr._bwd(*args, sums, torch.zeros_like(bg))


# Channel counts that the kernels run in their general instance (C = 1 and 3
# have instances of their own), at a small ragged shape: B, grid, object
# size, canvas.
OTHER_CHANNELS = (2, 4)
CHANNEL_SHAPE = (2, 3, 10, 15)


@functools.lru_cache(maxsize=None)
def _pallas_at_channels(c):
    """The JAX package's ``render_fused.py::fused_paste_render`` with
    ``num_channel`` c, in interpret mode at noise 0, fed the dense weights of
    the port's paste coordinates: (inputs, cotangent, forward, the gradients
    of objs, ys, xs, z_pres, depth_w, bg)."""
    b, g, os_, s = CHANNEL_SHAPE
    objs, z_where, z_pres, depth_w, bg = _inputs((b, g, os_, s, c), 17 + c)
    ys, xs, _ = tstn.paste_sample_coords(torch.from_numpy(z_where), (s, s), (os_, os_))
    arrays = [objs, ys.numpy(), xs.numpy(), z_pres, depth_w, bg]

    def jax_fn(o, y, x, zp, wd, bgi):
        return fused_paste_render(o, jax_interp_matrix(y, os_), jax_interp_matrix(x, os_), zp, wd,
                                  bgi, jnp.int32(0), 0.0, True)

    want = np.asarray(jax_fn(*map(jnp.asarray, arrays)))
    cot = np.random.RandomState(18).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * cot), argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays))
    return arrays, cot, want, [np.asarray(t) for t in jg]


@pytest.mark.parametrize("pair", ["full", "windowed"])
@pytest.mark.parametrize("c", OTHER_CHANNELS)
def test_plain_renders_match_pallas_at_other_channel_counts(c, pair):
    """The full-canvas and the row-windowed wrappers on CPU tensors at noise 0
    against the JAX full-canvas kernel at c channels (the windowed function
    differs from it by 1e-16 terms): forward and the six gradients."""
    seed = torch.zeros(1, dtype=torch.int32)
    wrapper = tr.fused_paste_render if pair == "full" else tw.fused_paste_render_windowed
    arrays, cot, want, jg = _pallas_at_channels(c)
    assert want.shape == (CHANNEL_SHAPE[0], CHANNEL_SHAPE[3], CHANNEL_SHAPE[3], c)
    got, tg = _torch_grads(lambda *a: wrapper(*a, seed, 0.0), arrays, cot)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    for n, a, bb in zip(("objs", "ys", "xs", "z_pres", "depth_w", "bg"), tg, jg):
        np.testing.assert_allclose(a, bb, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"gradient of {n} at {c} channels")


def _channel_inputs(c):
    b, g, os_, s = CHANNEL_SHAPE
    objs, z_where, z_pres, depth_w, bg = (torch.from_numpy(a)
                                          for a in _inputs((b, g, os_, s, c), 19))
    ys, xs, _ = tstn.paste_sample_coords(z_where, (s, s), (os_, os_))
    return objs, ys, xs, z_pres, depth_w, bg


@pytest.mark.parametrize("c", (1, 2, 3, 4, tr.MAX_CHANNELS))
def test_shape_checks_take_any_channel_count_up_to_the_cap(c):
    """Both render pairs' shape checks, on CPU tensors: every C from 1 to
    MAX_CHANNELS passes."""
    b, g, os_, s = CHANNEL_SHAPE
    for module in (tr, tw):
        assert module._shapes(*_channel_inputs(c)) == (b, g * g, os_, os_, s, s, c)


def test_shape_checks_refuse_channels_beyond_the_cap():
    for module in (tr, tw):
        with pytest.raises(ValueError, match="MAX_CHANNELS"):
            module._shapes(*_channel_inputs(tr.MAX_CHANNELS + 1))
