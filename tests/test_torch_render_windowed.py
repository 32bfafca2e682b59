"""The row-windowed render's plain versions (split_vae_torch.kernels.render_windowed)
against the JAX package's windowed Pallas kernel (interpret mode) and against
the port's full-canvas plain version (at 2 and 4 colour channels,
test_torch_render.py holds it to the JAX full-canvas Pallas kernel). The
wrapper takes the paste's sample coordinates ys, xs;
``render_windowed_taps_reference`` (its CPU path) is also held to the dense
``render_windowed_reference``, and ``compute_bands`` (the band rule the
kernels' find_band is held to on the card) to the rule written row by row.

Tolerances: forward atol 3e-5 and gradients rtol 1e-3, atol 3e-4 against the
Pallas kernel (tests/test_render_windowed.py:50,80: fp32 sums in another
order, and a 40-row window against the port's tighter band); forward atol
3e-6 against the full-canvas version (tests/test_render_windowed.py:60: the
two differ by terms of 1e-10). The CUDA kernels are held to this plain
version on the card by chip_smoke.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.core import tracing  # noqa: E402
from split_vae_torch.kernels import render as tr  # noqa: E402
from split_vae_torch.kernels import render_windowed as tw  # noqa: E402
from split_vae_torch.ops import stn as tstn  # noqa: E402
from split_vae_tpu.ops.stn import paste_interp_weights_ys as jax_weights_ys  # noqa: E402
from tools.pallas_research.render_windowed import (  # noqa: E402
    fused_paste_render_windowed as jax_windowed,
)
from tools.pallas_research.render_windowed import windowing_supported  # noqa: E402

B, GRID, C = 2, 4, 3
K = GRID * GRID
NAMES = ("objs", "z_where", "z_pres", "depth_w", "bg")


def _inputs(os_, s, seed):
    """tests/test_render_fused.py::_inputs, rebuilt with numpy at any shape."""
    rng = np.random.RandomState(seed)
    objs = rng.rand(B, K, os_, os_, C + 1).astype(np.float32)
    z_where = rng.randn(B, GRID, GRID, 4).astype(np.float32)
    z_pres = rng.rand(B, K).astype(np.float32)
    depth_w = (1.0 / (1.0 + np.exp(rng.randn(B, K))) + 0.5).astype(np.float32)
    bg = rng.rand(B, s, s, C).astype(np.float32)
    return [objs, z_where, z_pres, depth_w, bg]


def _port_windowed(os_, s, noise_scale=0.0, seed=0):
    def fn(objs, z_where, z_pres, depth_w, bg):
        ys, xs, _ = tstn.paste_sample_coords(z_where, (s, s), (os_, os_))
        return tw.fused_paste_render_windowed(objs, ys, xs, z_pres, depth_w, bg,
                                              torch.tensor([seed], dtype=torch.int32),
                                              noise_scale)
    return fn


def _port_full(os_, s, noise=None):
    def fn(objs, z_where, z_pres, depth_w, bg):
        wy, wx, _ = tstn.paste_interp_weights(z_where, (s, s), (os_, os_))
        return tr.render_reference(objs, wy, wx, z_pres, depth_w, bg, noise)
    return fn


def _torch_value_and_grads(fn, arrays, cot):
    tin = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*tin)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), tin)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def against_pallas():
    """Forward and the five gradients at 32 on 48: the JAX windowed kernel in
    interpret mode, and the port's wrapper on CPU tensors (the plain version)."""
    os_, s = 32, 48
    assert windowing_supported(os_, (s, s))
    arrays = _inputs(os_, s, 14)

    def jax_fn(objs, z_where, z_pres, depth_w, bg):
        wy, wx, _, ys = jax_weights_ys(z_where, (s, s), (os_, os_))
        return jax_windowed(objs, wy, wx, z_pres, depth_w, bg, jnp.int32(0), ys, 0.0, True)

    want = np.asarray(jax_fn(*map(jnp.asarray, arrays)))
    cot = np.random.RandomState(9).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * cot), argnums=tuple(range(5)))(
        *map(jnp.asarray, arrays))
    got, tg = _torch_value_and_grads(_port_windowed(os_, s), arrays, cot)
    return want, [np.asarray(g) for g in jg], got, tg


def test_forward_matches_pallas_windowed(against_pallas):
    want, _, got, _ = against_pallas
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("i", range(5), ids=NAMES)
def test_gradient_matches_pallas_windowed(against_pallas, i):
    _, jg, _, tg = against_pallas
    np.testing.assert_allclose(tg[i], jg[i], rtol=1e-3, atol=3e-4,
                               err_msg=f"gradient of {NAMES[i]}")


# 32 on 48 is the shape the JAX function takes; it refuses the other two
# (windowing_supported), so they are held to the full-canvas version only.
SHAPES = {"32on48": (32, 48), "28on48": (28, 48), "30on45": (30, 45)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_windowed_matches_full_canvas_version(name):
    os_, s = SHAPES[name]
    if name != "32on48":
        assert not windowing_supported(os_, (s, s))
    arrays = _inputs(os_, s, 13)
    cot = np.random.RandomState(3).randn(B, s, s, C).astype(np.float32)
    want, wg = _torch_value_and_grads(_port_full(os_, s), arrays, cot)
    got, tg = _torch_value_and_grads(_port_windowed(os_, s), arrays, cot)
    np.testing.assert_allclose(got, want, atol=3e-6)
    for n, a, b in zip(NAMES, tg, wg):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4, err_msg=f"gradient of {n}")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_band_covers_support(name):
    """No supported row (sample coordinate in (-1, h_obj)) escapes its band,
    extreme boxes included; an out-of-band row of wy is exactly zero."""
    os_, s = SHAPES[name]
    z_where = torch.from_numpy(_inputs(os_, s, 11)[1])
    z_where = torch.cat([z_where, 10.0 * torch.ones_like(z_where),
                         -10.0 * torch.ones_like(z_where),
                         torch.tensor([10.0, -10.0, 10.0, -10.0]) * torch.ones_like(z_where)])
    wy, _, _, ys = tstn.paste_interp_weights_ys(z_where, (s, s), (os_, os_))
    bands = tw.compute_bands(ys, os_)
    assert bands.dtype == torch.int32 and tuple(bands.shape) == (z_where.shape[0], K, 2)
    assert (bands[..., 0] >= 0).all() and (bands.sum(-1) <= s).all()
    inside = tw.band_mask(bands, s)
    valid = (ys > -1.0) & (ys < float(os_))
    assert not (valid & ~inside).any(), "a support row escaped its band"
    assert torch.count_nonzero(wy[~inside]) == 0
    assert bands[..., 1].max() < s, "the bands are no tighter than the canvas"


def test_empty_support_gives_an_empty_band_and_the_closed_form():
    """All sample coordinates outside the object: band (0, 0); the cells add
    only their closed-form terms, as the full-canvas version computes them."""
    os_, s = 8, 12
    rng = np.random.RandomState(5)
    ys = torch.full((1, 2, s), -3.0)
    assert torch.equal(tw.compute_bands(ys, os_), torch.zeros(1, 2, 2, dtype=torch.int32))
    objs = torch.from_numpy(rng.rand(1, 2, os_, os_, C + 1).astype(np.float32))
    xs = torch.from_numpy(rng.uniform(-1.0, os_, (1, 2, s)).astype(np.float32))
    zp, wd = torch.tensor([[0.3, 0.9]]), torch.tensor([[1.2, 0.7]])
    bg = torch.from_numpy(rng.rand(1, s, s, C).astype(np.float32))
    got = tw.fused_paste_render_windowed(objs, ys, xs, zp, wd, bg,
                                         torch.zeros(1, dtype=torch.int32), 0.0)
    want = tr.render_taps_reference(objs, ys, xs, zp, wd, bg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-7)


def test_g_wy_is_zero_outside_the_band():
    """The dense plain form (held against the Pallas kernel) gives wy no
    gradient outside the bands."""
    os_, s = 32, 48
    objs, z_where, z_pres, depth_w, bg = (torch.from_numpy(a) for a in _inputs(os_, s, 7))
    wy, wx, _, ys = tstn.paste_interp_weights_ys(z_where, (s, s), (os_, os_))
    wy.requires_grad_(True)
    bands = tw.compute_bands(ys, os_)
    out = tw.render_windowed_reference(objs, wy, wx, z_pres, depth_w, bg, bands)
    (g_wy,) = torch.autograd.grad(out.square().sum(), wy)
    inside = tw.band_mask(bands, s)
    assert torch.count_nonzero(g_wy[~inside]) == 0
    assert torch.count_nonzero(g_wy[inside]) > 0


def test_noise_matches_full_canvas_version_with_the_same_field():
    """At noise 0.01 the windowed wrapper (CPU: plain version, the seeded
    Philox field inside the bands) agrees with the full-canvas version given
    the same field, to the dropped ~1e-10 term."""
    os_, s, seed = 32, 48, 77
    arrays = _inputs(os_, s, 6)
    noise = 0.01 * tr.render_noise(torch.tensor([seed], dtype=torch.int32), B, K, C, s, s)
    cot = np.random.RandomState(4).randn(B, s, s, C).astype(np.float32)
    want, wg = _torch_value_and_grads(_port_full(os_, s, noise), arrays, cot)
    got, tg = _torch_value_and_grads(_port_windowed(os_, s, 0.01, seed), arrays, cot)
    np.testing.assert_allclose(got, want, atol=3e-6)
    assert np.abs(got - _torch_value_and_grads(_port_windowed(os_, s), arrays, cot)[0]).max() > 1e-4
    for n, a, b in zip(NAMES, tg, wg):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4, err_msg=f"gradient of {n}")


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    os_, s = 30, 45
    objs, z_where, z_pres, depth_w, bg = (torch.from_numpy(a) for a in _inputs(os_, s, 8))
    ys, xs, _ = tstn.paste_sample_coords(z_where, (s, s), (os_, os_))
    seed = torch.tensor([5], dtype=torch.int32)
    before = tracing.counters()
    got = tw.fused_paste_render_windowed(objs, ys, xs, z_pres, depth_w, bg, seed, 0.01)
    want = tw.render_windowed_taps_reference(objs, ys, xs, z_pres, depth_w, bg,
                                             0.01 * tr.render_noise(seed, B, K, C, s, s))
    assert torch.equal(got, want)
    assert tracing.counters() == before


def test_cuda_tensors_never_take_the_plain_version():
    """On a CUDA tensor the wrapper launches its kernel or raises; without a
    card the kernel entry points refuse CPU tensors."""
    os_, s = 8, 12
    objs, z_where, z_pres, depth_w, bg = (torch.from_numpy(a) for a in _inputs(os_, s, 2))
    ys, xs, _ = tstn.paste_sample_coords(z_where, (s, s), (os_, os_))
    args = (objs, ys, xs, z_pres, depth_w, bg, torch.zeros(1, dtype=torch.int32), 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        tw._fwd(*args)
    sums = torch.zeros((B, C + 2, s, s))
    with pytest.raises(ValueError, match="CUDA"):
        tw._bwd(*args, sums, torch.zeros_like(bg))


@pytest.mark.parametrize("model_kind,object_size", [("lg_spair", 16), ("lg_glimpse_spair", 12)])
def test_train_step_through_the_windowed_render(model_kind, object_size):
    """A small model's train step with ``windowed_render=True`` against the
    same step through the full-canvas render: same seed, so the same draws
    and the same render noise; the metrics agree to rtol 1e-5 and the
    parameters after the update to 1e-6. On the CPU neither launches a kernel."""
    from split_vae_torch.core.config import SpairConfig
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.optim import spair_optimizer
    from split_vae_torch.train.steps import make_spair_train_step

    cfg = SpairConfig(model=model_kind, batch_size=3, latent_size=8, bg_latent_size=8,
                      local_latent_size=8, object_size=object_size, patch_size=4,
                      image_size=(24, 24, 3), dense_bg=True, dense_local=True)
    x = torch.from_numpy(np.random.RandomState(1).uniform(0, 1, (3, 24, 24, 3))
                         .astype(np.float32))
    before = tracing.counters()
    results = []
    for windowed in (False, True):
        model = get_spair_model(cfg, device="cpu")
        state = create_train_state(model, spair_optimizer(cfg.learning_rate), seed=4)
        state, metrics = make_spair_train_step(cfg, windowed_render=windowed)(state, x)
        results.append(({k: float(v) for k, v in metrics.items()},
                        [p.detach().clone() for p in model.parameters()]))
    (m_full, p_full), (m_win, p_win) = results
    assert m_full["notfinite_updates"] == 0
    for k in m_full:
        np.testing.assert_allclose(m_win[k], m_full[k], rtol=1e-5, err_msg=k)
    for a, b in zip(p_win, p_full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    assert tracing.counters() == before


@pytest.mark.parametrize("z_scale", [1.0, 10.0])
def test_taps_version_matches_dense_version(z_scale):
    """``render_windowed_taps_reference`` against ``render_windowed_reference``
    over the dense weights of the same coordinates: the forward and the
    gradients of objs, z_pres, depth_w, bg agree, and those of ys and xs are
    the dense g_wy and g_wx carried through interp_matrix (-1 on a row's
    first tap, +1 on its second, 0 where the two coincide)."""
    os_, s = 32, 48
    objs, z_where, z_pres, depth_w, bg = (torch.from_numpy(a) for a in _inputs(os_, s, 21))
    ys, xs, _ = tstn.paste_sample_coords(z_scale * z_where, (s, s), (os_, os_))
    noise = 0.01 * tr.render_noise(torch.tensor([3], dtype=torch.int32), B, K, C, s, s)
    cot = torch.from_numpy(np.random.RandomState(22).randn(B, s, s, C).astype(np.float32))
    taps = [t.clone().requires_grad_(True) for t in (objs, ys, xs, z_pres, depth_w, bg)]
    out_t = tw.render_windowed_taps_reference(*taps, noise)
    g_t = torch.autograd.grad(out_t, taps, cot)
    dense = [t.clone().requires_grad_(True)
             for t in (objs, tr.interp_matrix(ys, os_), tr.interp_matrix(xs, os_), z_pres,
                       depth_w, bg)]
    out_d = tw.render_windowed_reference(*dense, tw.compute_bands(ys, os_), noise)
    g_d = torch.autograd.grad(out_d, dense, cot)
    assert torch.equal(out_t, out_d)

    def through_taps(g_w, u, n):
        i0 = torch.clamp(torch.floor(u), 0.0, n - 1.0).long()[..., None]
        i1 = torch.clamp(torch.floor(u) + 1.0, 0.0, n - 1.0).long()[..., None]
        return (g_w.gather(-1, i1) - g_w.gather(-1, i0))[..., 0]

    want = [g_d[0], through_taps(g_d[1], ys, os_), through_taps(g_d[2], xs, os_), *g_d[3:]]
    for n, a, b in zip(("objs", "ys", "xs", "z_pres", "depth_w", "bg"), g_t, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"gradient of {n}")


def _band_case(name):
    """Row coordinates for the band rule: random boxes, boxes at z_where x10,
    cells with no supported row, each on a 48-row canvas (two ballots of 32
    rows) or a 70-row one (three)."""
    kind, s = name.rsplit("_", 1)
    s = int(s)
    os_ = 2 * s // 3
    z_where = torch.from_numpy(np.random.RandomState(23).randn(4, GRID, GRID, 4)
                               .astype(np.float32))
    if kind == "empty":
        ys = torch.from_numpy(np.random.RandomState(24).choice(
            [-50.0, -1.0, os_, 1e6], (4, K, s)).astype(np.float32))
        return ys, os_
    scale = 10.0 if kind == "x10" else 1.0
    ys, _, _ = tstn.paste_sample_coords(scale * z_where, (s, s), (os_, os_))
    return ys, os_


def _rule_bands(ys, os_):
    """The band rule cell by cell: [first - 1, last + 2) around the supported
    rows (coordinate in (-1, os_)), clipped to the canvas; (0, 0) for none."""
    hh = ys.shape[-1]
    out = np.zeros(ys.shape[:-1] + (2,), np.int32)
    for idx in np.ndindex(*ys.shape[:-1]):
        rows = [y for y in range(hh) if -1.0 < float(ys[idx + (y,)]) < os_]
        if rows:
            start, end = max(rows[0] - 1, 0), min(rows[-1] + 2, hh)
            out[idx] = (start, end - start)
    return torch.from_numpy(out)


@pytest.mark.parametrize("name", ["random_48", "x10_48", "empty_48", "random_70", "x10_70"])
def test_compute_bands_follows_the_rule(name):
    """``compute_bands`` gives the rule's bands, row by row, on random, x10
    and empty-support coordinates, over two and three 32-row ballots."""
    ys, os_ = _band_case(name)
    want = _rule_bands(ys, os_)
    assert torch.equal(tw.compute_bands(ys, os_), want)
    if name.startswith("empty"):
        assert not want.any()
    else:
        assert want[..., 1].min() < want[..., 1].max(), "the case has bands of one length only"


@pytest.mark.parametrize("z_scale", [1.0, 10.0])
def test_g_ys_is_zero_outside_the_band(z_scale):
    """Through the wrapper (CPU: the plain version), ys gets no gradient on
    the rows outside each band, and some inside."""
    os_, s = 32, 48
    objs, z_where, z_pres, depth_w, bg = (torch.from_numpy(a) for a in _inputs(os_, s, 7))
    ys, xs, _ = tstn.paste_sample_coords(z_scale * z_where, (s, s), (os_, os_))
    ys.requires_grad_(True)
    out = tw.fused_paste_render_windowed(objs, ys, xs, z_pres, depth_w, bg,
                                         torch.tensor([9], dtype=torch.int32), 0.01)
    (g_ys,) = torch.autograd.grad(out.square().sum(), ys)
    inside = tw.band_mask(tw.compute_bands(ys.detach(), os_), s)
    assert torch.count_nonzero(g_ys[~inside]) == 0
    assert torch.count_nonzero(g_ys[inside]) > 0
