"""The STN glimpse crop of the port (split_vae_torch.kernels.crop) against the
JAX package: the Pallas crop kernels in interpret mode, the einsum form of
ops.stn.stn_crop and ops.stn.stn_crop itself.

Seeded numpy inputs go through both. The port's crop takes the sample
coordinates ys, xs (``stn_crop_taps``); the JAX side builds the dense
weights from the same coordinates with its ``_interp_matrix`` and runs the
Pallas crop or the two einsums of ``split_vae_tpu/ops/stn.py::stn_crop``.
Coordinates come at random and at the edges (integers, exactly n-1, inside
(-1, 0) and (n-1, n), 20 px beyond the image), where the two taps of a row
coincide and the row is 0. Forward atol 1e-5; gradients of img, ys and xs
rtol 1e-3, atol 1e-4 * max|g| (fp32 sums in another order; what
tests/test_torch_stn.py holds downstream of the coordinates). The dense plain
form ``crop_reference`` and its hand-written backward
``crop_backward_reference``, on weights handed over from JAX, are held to both
Pallas crops: forward atol 3e-5, the limit tests/test_crop_fused.py holds
them to.
Through ``stn_crop`` from raw z_where the same limits apply, as XLA and torch
round the coordinates differently by an ulp.

On the CPU the wrapper's autograd.Function runs the plain version and
autograd through it; float64 gradcheck holds it at non-integer coordinates.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.core import tracing  # noqa: E402
from split_vae_torch.kernels import crop as tcrop  # noqa: E402
from split_vae_torch.ops import stn as ts  # noqa: E402
from split_vae_tpu.ops import stn as js  # noqa: E402
from tools.pallas_research.crop_fused import fused_stn_crop_apply  # noqa: E402
from tools.pallas_research.crop_packed import (  # noqa: E402
    crop_packing_supported,
    fused_stn_crop_packed,
)

SHAPES = [(48, 32, 3), (48, 32, 6), (48, 28, 3)]  # canvas, glimpse, channels
B, GRID = 2, 4


def _inputs(canvas, glimpse, c, seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(B, canvas, canvas, c).astype(np.float32)
    z_where = rng.randn(B, GRID, GRID, 4).astype(np.float32)
    sx, sy, tx, ty = js.zwhere_to_params(jnp.asarray(z_where))
    wx = np.array(js._interp_matrix(js._sample_coords(sx, tx, glimpse, canvas), canvas))
    wy = np.array(js._interp_matrix(js._sample_coords(sy, ty, glimpse, canvas), canvas))
    cot = rng.randn(B, GRID * GRID, glimpse, glimpse, c).astype(np.float32)
    return img, z_where, wy, wx, cot


def _edge_coords(rng, n, count):
    """[B, K, count] coordinates on an axis of length n: every edge case of the
    taps in each cell (integers, n-1, (-1, 0), (n-1, n), 20 px outside), the
    rest uniform over [-1.5, n + 0.5], in a random order per cell."""
    edges = np.array([0.0, 5.0, 17.0, n - 1.0, -0.5, -0.25, n - 0.7, n - 0.1, -20.0,
                      n + 19.0], np.float32)
    out = rng.uniform(-1.5, n + 0.5, (B, GRID * GRID, count)).astype(np.float32)
    out[..., :len(edges)] = edges
    for cell in out.reshape(-1, count):
        rng.shuffle(cell)
    return out


def _coord_inputs(canvas, glimpse, c, kind, seed):
    """img, ys, xs and a cotangent; ``kind`` "random" takes the coordinates of
    random boxes, "edge" those of ``_edge_coords``."""
    rng = np.random.RandomState(seed)
    img = rng.rand(B, canvas, canvas, c).astype(np.float32)
    if kind == "edge":
        ys, xs = _edge_coords(rng, canvas, glimpse), _edge_coords(rng, canvas, glimpse)
    else:
        sx, sy, tx, ty = js.zwhere_to_params(jnp.asarray(rng.randn(B, GRID, GRID, 4),
                                                         jnp.float32))
        ys = np.array(js._sample_coords(sy, ty, glimpse, canvas))
        xs = np.array(js._sample_coords(sx, tx, glimpse, canvas))
    cot = rng.randn(B, GRID * GRID, glimpse, glimpse, c).astype(np.float32)
    return img, ys, xs, cot


def _jax_crops(canvas, glimpse, c):
    fns = {"crop_fused": lambda i, y, x: fused_stn_crop_apply(i, y, x, True)}
    if crop_packing_supported((canvas, canvas), (glimpse, glimpse), c):
        fns["crop_packed"] = lambda i, y, x: fused_stn_crop_packed(i, y, x, True)
    return fns


def _jax_einsums(img, wy, wx):
    tmp = jnp.einsum("bkpi,bijc->bkpjc", wy, img)
    return jnp.einsum("bkpjc,bkqj->bkpqc", tmp, wx)


@pytest.mark.parametrize("canvas,glimpse,c", SHAPES)
def test_forward_matches_pallas_crops(canvas, glimpse, c):
    img, _, wy, wx, _ = _inputs(canvas, glimpse, c, 0)
    got = tcrop.crop_reference(*map(torch.from_numpy, (img, wy, wx))).numpy()
    for name, fn in _jax_crops(canvas, glimpse, c).items():
        want = np.asarray(fn(jnp.asarray(img), jnp.asarray(wy), jnp.asarray(wx)))
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("canvas,glimpse,c", SHAPES)
def test_gradients_match_pallas_crops(canvas, glimpse, c):
    img, _, wy, wx, cot = _inputs(canvas, glimpse, c, 1)
    got = tcrop.crop_backward_reference(*map(torch.from_numpy, (img, wy, wx, cot)))
    for name, fn in _jax_crops(canvas, glimpse, c).items():
        _, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(wy), jnp.asarray(wx))
        for which, g, w in zip(("img", "wy", "wx"), got, vjp(jnp.asarray(cot))):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{name}: gradient of {which}")


@pytest.mark.parametrize("kind", ["random", "edge"])
@pytest.mark.parametrize("canvas,glimpse,c", SHAPES)
def test_coordinate_crop_matches_pallas_crop_and_einsums(canvas, glimpse, c, kind):
    """stn_crop_taps(img, ys, xs) against the einsum form and, at the edge
    coordinates, the Pallas crop on _interp_matrix(ys), _interp_matrix(xs):
    forward and the gradients of img, ys and xs."""
    img, ys, xs, cot = _coord_inputs(canvas, glimpse, c, kind, 6)
    tin = [torch.tensor(a, requires_grad=True) for a in (img, ys, xs)]
    out = tcrop.stn_crop_taps(*tin)
    got = torch.autograd.grad(out, tin, torch.from_numpy(cot))
    dense = {"einsum": _jax_einsums}
    if kind == "edge" and c == 3:  # interpret mode is slow; C=6 adds nothing to the taps
        dense["crop_fused"] = lambda i, y, x: fused_stn_crop_apply(i, y, x, True)
    for name, crop in dense.items():
        def fn(i, y, x, crop=crop):
            return crop(i, js._interp_matrix(y, canvas), js._interp_matrix(x, canvas))

        want, vjp = jax.vjp(fn, *map(jnp.asarray, (img, ys, xs)))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0,
                                   err_msg=f"{name}: forward")
        for which, g, w in zip(("img", "ys", "xs"), got, vjp(jnp.asarray(cot))):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{name}: gradient of {which}")


@pytest.mark.parametrize("kind", ["random", "edge"])
def test_taps_reference_is_the_dense_reference(kind):
    """The coordinate form against the dense one on the same (bit-equal)
    weights, and the port's weights bit-equal to the JAX package's."""
    img, ys, xs, _ = _coord_inputs(48, 32, 3, kind, 7)
    wy_j = np.asarray(js._interp_matrix(jnp.asarray(ys), 48))
    wy = tcrop.interp_matrix(torch.from_numpy(ys), 48)
    wx = tcrop.interp_matrix(torch.from_numpy(xs), 48)
    np.testing.assert_array_equal(wy.numpy(), wy_j)
    got = tcrop.crop_taps_reference(*map(torch.from_numpy, (img, ys, xs)))
    want = tcrop.crop_reference(torch.from_numpy(img), wy, wx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_out_of_image_rule():
    """Coinciding taps give a zero sample and zero coordinate gradients: at
    exactly n-1, inside (-1, 0), beyond n-1 and far outside, on either axis."""
    n = 6
    img = torch.rand(1, n, n, 2) + 1.0
    inside = torch.tensor([[[2.25]]])
    for u in (n - 1.0, -0.5, n - 0.5, 30.0, -30.0):
        edge = torch.tensor([[[u]]], requires_grad=True)
        ys, xs = inside.clone().requires_grad_(True), inside.clone().requires_grad_(True)
        for args, grad_of in (((img, edge, xs), edge), ((img, ys, edge), edge)):
            out = tcrop.stn_crop_taps(*args)
            assert torch.equal(out, torch.zeros_like(out)), u
            (g,) = torch.autograd.grad(out.sum(), [grad_of])
            assert g.item() == 0.0, u
    # Inside, the sample is the bilinear mix and its gradient the difference.
    out = tcrop.stn_crop_taps(img, inside, inside)
    want = 0.5625 * img[0, 2, 2] + 0.1875 * (img[0, 2, 3] + img[0, 3, 2]) + 0.0625 * img[0, 3, 3]
    np.testing.assert_allclose(out[0, 0, 0, 0].numpy(), want.numpy(), rtol=1e-6)


def test_plain_backward_is_the_forwards_gradient():
    """float64 gradcheck of the autograd.Function's CPU path and of the plain
    version, all three inputs, at non-integer coordinates inside and outside."""
    rng = np.random.RandomState(3)
    img = torch.tensor(rng.rand(2, 7, 6, 2), dtype=torch.float64, requires_grad=True)
    ys = rng.uniform(-2.0, 8.0, (2, 3, 5))
    xs = rng.uniform(-2.0, 7.0, (2, 3, 4))
    # Keep off integers by 0.05, where the taps change and finite differences jump.
    ys, xs = (torch.tensor(np.floor(a) + 0.05 + 0.9 * (a - np.floor(a)), dtype=torch.float64,
                           requires_grad=True) for a in (ys, xs))
    assert torch.autograd.gradcheck(tcrop.StnCropTaps.apply, (img, ys, xs), eps=1e-6)
    assert torch.autograd.gradcheck(tcrop.crop_taps_reference, (img, ys, xs), eps=1e-6)


@pytest.mark.parametrize("need", [(True, False, False), (False, True, True),
                                  (False, False, True)])
def test_only_the_gradients_asked_for(need):
    rng = np.random.RandomState(4)
    arrays = (rng.rand(2, 8, 8, 3), rng.uniform(-1, 8, (2, 4, 5)), rng.uniform(-1, 8, (2, 4, 6)))
    tin = [torch.tensor(a, dtype=torch.float32, requires_grad=n) for a, n in zip(arrays, need)]
    ref = [t.detach().clone().requires_grad_(n) for t, n in zip(tin, need)]
    tcrop.stn_crop_taps(*tin).square().sum().backward()
    tcrop.crop_taps_reference(*ref).square().sum().backward()
    for t, r, n in zip(tin, ref, need):
        assert (t.grad is not None) == n
        if n:
            np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_launch_no_kernel_and_shapes_are_checked():
    launches = tracing.counters()
    img = torch.rand(1, 8, 8, 3, requires_grad=True)
    ys, xs = torch.rand(1, 4, 5) * 7, torch.rand(1, 4, 6) * 7
    tcrop.stn_crop_taps(img, ys, xs).sum().backward()
    assert tracing.counters() == launches
    with pytest.raises(ValueError, match="xs"):
        tcrop.stn_crop_taps(img, ys, torch.rand(1, 3, 6))
    with pytest.raises(ValueError, match="ys"):
        tcrop.stn_crop_taps(img, torch.rand(2, 4, 5), xs)
    with pytest.raises(ValueError, match="need img"):
        tcrop.stn_crop_taps(img, ys[0], xs)


def test_cuda_wrapper_takes_no_cpu_tensor():
    """The kernels' entry points raise on a CPU tensor: no plain fallback."""
    img, ys, xs = torch.rand(1, 8, 8, 3), torch.rand(1, 4, 5), torch.rand(1, 4, 6)
    with pytest.raises(ValueError, match="CUDA"):
        tcrop._fwd(img, ys, xs)
    with pytest.raises(ValueError, match="CUDA"):
        tcrop._bwd(img, ys, xs, torch.rand(1, 4, 5, 6, 3))


@pytest.mark.parametrize("canvas,glimpse,c", SHAPES)
def test_stn_crop_matches_jax_stn_crop(canvas, glimpse, c):
    img, z_where, _, _, cot = _inputs(canvas, glimpse, c, 2)
    out_hw = (glimpse, glimpse)
    want, vjp = jax.vjp(lambda i, z: js.stn_crop(i, z, out_hw)[0], jnp.asarray(img),
                        jnp.asarray(z_where))
    tin = [torch.tensor(a, requires_grad=True) for a in (img, z_where)]
    got = ts.stn_crop(*tin, out_hw)[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)
    grads = torch.autograd.grad(got, tin, torch.from_numpy(cot))
    for which, g, w in zip(("img", "z_where"), grads, vjp(jnp.asarray(cot))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"gradient of {which}")


def test_paste_interp_weights_ys():
    rng = np.random.RandomState(5)
    z_where = rng.randn(2, 2, 2, 4).astype(np.float32)
    want = js.paste_interp_weights_ys(jnp.asarray(z_where), (24, 24), (16, 16))
    got = ts.paste_interp_weights_ys(torch.from_numpy(z_where), (24, 24), (16, 16))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=3e-5)
