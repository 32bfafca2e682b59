"""The STN glimpse crop of the port (split_vae_torch.kernels.crop) against the
JAX package: the Pallas crop kernels in interpret mode and ops.stn.stn_crop.

Seeded numpy inputs go through both. The interpolation weights are built once
(by the JAX package) and handed to both sides, so the crop itself is compared
on identical inputs: forward atol 3e-5 (the limit tests/test_crop_fused.py
holds the Pallas kernels to), the three gradients at rtol 1e-3 with atol
1e-4 * max|g| (what tests/test_torch_stn.py holds downstream of the sample
coordinates). Through ``stn_crop`` from raw z_where the same limits apply, as
XLA and torch round the coordinates differently by an ulp.

On the CPU the wrapper's autograd.Function runs its plain forward and its
hand-written plain backward (the three product families the CUDA kernel
computes); float64 gradcheck holds that backward to the forward.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

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


def _jax_crops(canvas, glimpse, c):
    fns = {"crop_fused": lambda i, y, x: fused_stn_crop_apply(i, y, x, True)}
    if crop_packing_supported((canvas, canvas), (glimpse, glimpse), c):
        fns["crop_packed"] = lambda i, y, x: fused_stn_crop_packed(i, y, x, True)
    return fns


@pytest.mark.parametrize("canvas,glimpse,c", SHAPES)
def test_forward_matches_pallas_crops(canvas, glimpse, c):
    img, _, wy, wx, _ = _inputs(canvas, glimpse, c, 0)
    got = tcrop.stn_crop_apply(*map(torch.from_numpy, (img, wy, wx))).numpy()
    for name, fn in _jax_crops(canvas, glimpse, c).items():
        want = np.asarray(fn(jnp.asarray(img), jnp.asarray(wy), jnp.asarray(wx)))
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("canvas,glimpse,c", SHAPES)
def test_gradients_match_pallas_crops(canvas, glimpse, c):
    img, _, wy, wx, cot = _inputs(canvas, glimpse, c, 1)
    tin = [torch.tensor(a, requires_grad=True) for a in (img, wy, wx)]
    got = torch.autograd.grad(tcrop.stn_crop_apply(*tin), tin, torch.from_numpy(cot))
    for name, fn in _jax_crops(canvas, glimpse, c).items():
        _, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(wy), jnp.asarray(wx))
        for which, g, w in zip(("img", "wy", "wx"), got, vjp(jnp.asarray(cot))):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{name}: gradient of {which}")


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


def test_plain_backward_is_the_forwards_gradient():
    """float64 gradcheck of the autograd.Function's CPU path, all three inputs."""
    rng = np.random.RandomState(3)
    img = torch.tensor(rng.rand(2, 7, 6, 2), dtype=torch.float64, requires_grad=True)
    wy = torch.tensor(rng.randn(2, 3, 5, 7), dtype=torch.float64, requires_grad=True)
    wx = torch.tensor(rng.randn(2, 3, 4, 6), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(tcrop.StnCropApply.apply, (img, wy, wx))


@pytest.mark.parametrize("need", [(True, False, False), (False, True, True),
                                  (False, False, True)])
def test_only_the_gradients_asked_for(need):
    rng = np.random.RandomState(4)
    arrays = (rng.rand(2, 8, 8, 3), rng.randn(2, 4, 5, 8), rng.randn(2, 4, 5, 8))
    tin = [torch.tensor(a, dtype=torch.float32, requires_grad=n) for a, n in zip(arrays, need)]
    ref = [t.detach().clone().requires_grad_(n) for t, n in zip(tin, need)]
    tcrop.stn_crop_apply(*tin).square().sum().backward()
    tcrop.crop_reference(*ref).square().sum().backward()
    for t, r, n in zip(tin, ref, need):
        assert (t.grad is not None) == n
        if n:
            np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_launch_no_kernel_and_shapes_are_checked():
    launches = (tcrop.fwd_launches, tcrop.bwd_launches)
    img = torch.rand(1, 8, 8, 3, requires_grad=True)
    wy, wx = torch.rand(1, 4, 5, 8), torch.rand(1, 4, 5, 8)
    tcrop.stn_crop_apply(img, wy, wx).sum().backward()
    assert (tcrop.fwd_launches, tcrop.bwd_launches) == launches
    with pytest.raises(ValueError, match="wx"):
        tcrop._shapes(img, wy, torch.rand(1, 4, 5, 9))


def test_paste_interp_weights_ys():
    rng = np.random.RandomState(5)
    z_where = rng.randn(2, 2, 2, 4).astype(np.float32)
    want = js.paste_interp_weights_ys(jnp.asarray(z_where), (24, 24), (16, 16))
    got = ts.paste_interp_weights_ys(torch.from_numpy(z_where), (24, 24), (16, 16))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=3e-5)
