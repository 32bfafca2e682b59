"""split_vae_torch.ops.stn against split_vae_tpu.ops.stn: values and gradients.

Seeded numpy inputs go through both packages (fp32 on the CPU). The box
parameters, the boxes and the interpolation weights for given sample
coordinates agree at rtol 1e-5, atol 1e-6. Crop and paste weights are built
from sample coordinates at pixel scale (up to 47), where one fp32 ulp is
3.8e-6, and XLA's sigmoid, tanh and linspace round differently from torch's
by an ulp: so everything downstream of the coordinates is held at atol 3e-5
(8 ulps at that scale) and rtol 1e-4. Its gradients are sums over many pixels
that partly cancel; they are held at rtol 1e-3, atol 1e-4 * max|g|.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.ops import stn as ts  # noqa: E402
from split_vae_tpu.ops import stn as js  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


COORD_RTOL, COORD_ATOL = 1e-4, 3e-5


def _check(jax_fn, torch_fn, arrays, seed=0, rtol=RTOL, atol=ATOL, coords=False):
    """Every output and the gradient of a random projection of all outputs."""
    jouts = jax_fn(*[jnp.asarray(a) for a in arrays])
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    rng = np.random.RandomState(seed + 7)
    ws = [rng.randn(*o.shape).astype(np.float32) for o in jouts]

    def jloss(*a):
        outs = jax_fn(*a)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))

    jg = jax.grad(jloss, argnums=tuple(range(len(arrays))))(*[jnp.asarray(a) for a in arrays])
    tin = [torch.tensor(a, requires_grad=True) for a in arrays]
    touts = torch_fn(*tin)
    touts = touts if isinstance(touts, tuple) else (touts,)
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol,
                                   err_msg=f"output {i}")
    tg = torch.autograd.grad(sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(touts, ws)),
                             tin)
    for i, (t, j) in enumerate(zip(tg, jg)):
        j = np.asarray(j)
        if coords:
            rtol, atol = 1e-3, 1e-4 * np.abs(j).max()
        np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=atol,
                                   err_msg=f"gradient of input {i}")


def _z_where(rng, b=3, gh=2, gw=2):
    return rng.randn(b, gh, gw, 4).astype(np.float32)


@pytest.mark.parametrize("grid", [(2, 2), (4, 4), (1, 3)])
def test_zwhere_to_params_and_bbox(grid):
    rng = np.random.RandomState(0)
    zw = _z_where(rng, 3, *grid)
    _check(js.zwhere_to_params, ts.zwhere_to_params, [zw])
    _check(lambda z: js.zwhere_to_bbox(*js.zwhere_to_params(z)),
           lambda z: ts.zwhere_to_bbox(*ts.zwhere_to_params(z)), [zw])


@pytest.mark.parametrize("in_size", [16, 7])
def test_interp_matrix_including_out_of_range(in_size):
    rng = np.random.RandomState(1)
    # Samples inside, at, and well outside [0, in_size - 1], off exact integers.
    coords = rng.uniform(-4.0, in_size + 3.0, (3, 5, 9)).astype(np.float32)
    _check(lambda c: js._interp_matrix(c, in_size), lambda c: ts._interp_matrix(c, in_size),
           [coords])


@pytest.mark.parametrize("img_hw,out_hw", [((24, 24), (16, 16)), ((48, 48), (32, 32)),
                                           ((45, 45), (30, 30))])
def test_stn_crop(img_hw, out_hw):
    rng = np.random.RandomState(2)
    img = rng.rand(2, *img_hw, 3).astype(np.float32)
    zw = _z_where(rng, 2)
    _check(lambda i, z: js.stn_crop(i, z, out_hw), lambda i, z: ts.stn_crop(i, z, out_hw),
           [img, zw], rtol=COORD_RTOL, atol=COORD_ATOL, coords=True)


@pytest.mark.parametrize("obj,canvas", [(16, 24), (32, 48), (30, 45)])
def test_paste_interp_weights_and_stn_paste(obj, canvas):
    rng = np.random.RandomState(3)
    zw = _z_where(rng, 2)
    _check(lambda z: js.paste_interp_weights(z, (canvas, canvas), (obj, obj)),
           lambda z: ts.paste_interp_weights(z, (canvas, canvas), (obj, obj)), [zw],
           rtol=COORD_RTOL, atol=COORD_ATOL, coords=True)
    objs = rng.rand(2, 4, obj, obj, 4).astype(np.float32)
    _check(lambda o, z: js.stn_paste(o, z, (canvas, canvas)),
           lambda o, z: ts.stn_paste(o, z, (canvas, canvas)), [objs, zw],
           rtol=COORD_RTOL, atol=COORD_ATOL, coords=True)
