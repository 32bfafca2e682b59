"""The port's PNG artifacts (split_vae_torch/viz) against the JAX package's.

- ``viz/canvases.py`` is bit-equal to the JAX one on seeded inputs,
  degenerate and edge boxes included.
- ``viz/png.py`` round-trips an 8-bit image exactly; PIL reads its files.
- The VAE writers: the JAX loop's ``_vae_visualize`` and the port's on tiny
  models with the same parameters (``interop/flax_params.py``) and the same
  draws. The JAX side runs eagerly with its samplers (``jax.random.normal``,
  ``uniform``, ``randint``, ``permutation``) drawing from a seeded numpy
  stream, which is kept and replayed into the port's ``Noise``. Held: the
  same PNG names at one eval (LGVae on celeba: 7; LGGMVae on svhn with
  ``--viz``; GMVae: none), each canvas at atol 1e-4, and each file's pixels
  within one 8-bit level of the JAX canvas. The writers no loop calls
  (``generate_traverse``, ``plot_latent_dims``, ``unseen_cluster*``) are held
  the same way.
- The SPAIR writers get one fixed model output on both sides (the JAX
  ``_forward`` and the port's are monkeypatched to return it): the returned
  canvases at 1e-6, and each PNG equal to the panels the JAX writer hands
  ``imshow`` (captured by a stub of its ``plt``), side by side.
- The SPAIR loop's names for one eval, LG-SPAIR and LGGlimpseSPAIR with two
  test sets, against the list of split_vae_tpu/train/loop.py:343-389.
"""

import os
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import split_vae_tpu.viz.artifacts as jax_viz  # noqa: E402
import split_vae_tpu.viz.spair_artifacts as jax_sviz  # noqa: E402
from split_vae_torch.core.config import SpairConfig as PortSpairConfig  # noqa: E402
from split_vae_torch.core.config import VaeConfig as PortConfig  # noqa: E402
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.interop.flax_params import load_flax_params  # noqa: E402
from split_vae_torch.models.spair import SpairOutput as PortSpairOutput  # noqa: E402
from split_vae_torch.models.spair import get_spair_model  # noqa: E402
from split_vae_torch.models.vae import get_vae_model  # noqa: E402
from split_vae_torch.train import loop as port_loop  # noqa: E402
from split_vae_torch.train.steps import make_spair_eval_step  # noqa: E402
from split_vae_torch.viz import artifacts as port_viz  # noqa: E402
from split_vae_torch.viz import canvases as port_canvases  # noqa: E402
from split_vae_torch.viz import png  # noqa: E402
from split_vae_torch.viz import spair_artifacts as port_sviz  # noqa: E402
from split_vae_tpu.core.config import VaeConfig  # noqa: E402
from split_vae_tpu.models.spair import SpairOutput  # noqa: E402
from split_vae_tpu.models.vae import GMVae, LGGMVae, LGVae  # noqa: E402
from split_vae_tpu.train import loop as jax_loop  # noqa: E402
from split_vae_tpu.viz import canvases as jax_canvases  # noqa: E402

HW, LATENT, Y = (16, 16), 4, 5


# --- canvases -------------------------------------------------------------------------------

def _images(seed, shape=(6, 8, 10, 3)):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("rows, cols", [(2, 3), (1, 6), (3, 1)])
def test_grid_canvas_is_the_jax_one(rows, cols):
    x = _images(rows * 10 + cols)
    np.testing.assert_array_equal(port_canvases.grid_canvas(x, rows, cols),
                                  jax_canvases.grid_canvas(x, rows, cols))


def test_stack_rows_and_to_unit_are_the_jax_ones():
    a, b = _images(1), _images(2)
    np.testing.assert_array_equal(port_canvases.stack_rows(a, b), jax_canvases.stack_rows(a, b))
    np.testing.assert_array_equal(port_canvases.to_unit(a * 1.5), jax_canvases.to_unit(a * 1.5))


@pytest.mark.parametrize("channels", [1, 3])
def test_draw_bounding_boxes_is_the_jax_one(channels):
    rng = np.random.RandomState(channels)
    images = rng.uniform(0, 1, (3, 12, 14, channels)).astype(np.float32)
    lo = rng.uniform(-0.2, 0.6, (3, 5, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.6, (3, 5, 2))], axis=-1)
    boxes = boxes[..., [0, 1, 2, 3]].astype(np.float32)
    boxes[0, 0] = 0.0                       # masked out: all zero
    boxes[0, 1] = [0.5, 0.5, 0.5, 0.9]      # no height
    boxes[1, 0] = [0.2, 0.7, 0.6, 0.3]      # negative width
    boxes[1, 1] = [-0.5, -0.5, 1.5, 1.5]    # beyond every edge
    boxes[2, 0] = [0.0, 0.0, 1.0, 1.0]      # on the edges
    got = port_canvases.draw_bounding_boxes(images, boxes)
    np.testing.assert_array_equal(got, jax_canvases.draw_bounding_boxes(images, boxes))
    assert got.dtype == images.dtype and not np.array_equal(got, images)


# --- PNG ------------------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 9), (5, 11, 3)], ids=["gray", "rgb"])
def test_png_round_trip_is_exact(tmp_path, shape):
    canvas = np.random.RandomState(0).uniform(-0.2, 1.2, shape)
    path = str(tmp_path / "x.png")
    written = png.write_png(path, canvas)
    image, header = png.read_png(path)
    np.testing.assert_array_equal(image, written)
    np.testing.assert_array_equal(written, png.to_uint8(canvas))
    assert (header["width"], header["height"]) == (shape[1], shape[0])
    assert header["color_type"] == (0 if len(shape) == 2 else 2)
    if len(shape) == 3:  # RGB: clipped to [0, 1]
        np.testing.assert_array_equal(written, np.rint(np.clip(canvas, 0, 1) * 255))
    else:  # gray: min-max scaled
        assert written.min() == 0 and written.max() == 255
    pil = pytest.importorskip("PIL.Image")
    with pil.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), written)


def test_png_panels_and_bad_files(tmp_path):
    rgb, gray = np.full((4, 3, 3), 0.5), np.arange(10.0).reshape(5, 2)
    path = str(tmp_path / "p.png")
    image = png.write_panels(path, [rgb, gray])
    assert image.shape == (5, 3 + png.PANEL_GAP + 2, 3)
    np.testing.assert_array_equal(image[:, 3:3 + png.PANEL_GAP], 255)  # the gap
    np.testing.assert_array_equal(image[4, :3], 255)  # the shorter panel's padding
    np.testing.assert_array_equal(image[:, -2:, 0], image[:, -2:, 2])  # gray on 3 channels
    np.testing.assert_array_equal(png.read_png(path)[0], image)
    with open(path, "r+b") as f:  # one flipped pixel byte: the CRC no longer holds
        data = bytearray(f.read())
        data[-20] ^= 0xFF
        f.seek(0)
        f.write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(path)


# --- VAE writers ----------------------------------------------------------------------------

class SeededDraws:
    """The JAX samplers, drawing from a seeded numpy stream instead; each draw
    is kept, in call order, as the port's ``Noise`` replays it."""

    def __init__(self, mp, seed=0):
        self.rng, self.draws = np.random.RandomState(seed), []
        mp.setattr(jax.random, "normal", self.normal)
        mp.setattr(jax.random, "uniform", self.uniform)
        mp.setattr(jax.random, "randint", self.randint)
        mp.setattr(jax.random, "permutation", self.permutation)

    def _keep(self, a: np.ndarray):
        """Keeps a draw (cast in numpy, so a jitted caller gets a constant)."""
        self.draws.append(a.astype(np.int64 if a.dtype.kind == "i" else np.float32))
        return jnp.asarray(a)

    def normal(self, key, shape=(), dtype=jnp.float32):
        return self._keep(np.asarray(self.rng.standard_normal(shape), dtype))

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        # Kept off 0 and 1, which a bfloat16 or float32 rounding could reach.
        return self._keep(np.asarray(self.rng.uniform(0.01, 0.99, shape), dtype))

    def randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        return self._keep(self.rng.randint(minval, maxval, shape).astype(np.int32))

    def permutation(self, key, x, *args, **kwargs):
        return self._keep(self.rng.permutation(x).astype(np.int32))

    def noise(self):
        return Noise(torch.Generator(), self.draws)


@pytest.fixture
def eager_jax_viz(monkeypatch):
    """The JAX writers eager (their jitted forwards would fix the draws at
    trace time), and their canvases kept by name instead of drawn by
    matplotlib (an empty file is written, so the names are on disk)."""
    for cached in (jax_viz._encode_jit, jax_viz._decode_jit, jax_viz._prior_for_y_jit,
                   jax_viz._get_y_jit):
        cached.cache_clear()
    monkeypatch.setattr(jax_viz, "jax", types.SimpleNamespace(jit=lambda f: f, random=jax.random,
                                                              nn=jax.nn))
    canvases = {}

    def save(canvas, path, figsize=None):
        canvases[os.path.basename(path)] = np.asarray(canvas, np.float64)
        open(path, "wb").close()

    monkeypatch.setattr(jax_viz, "_save", save)
    yield canvases
    for cached in (jax_viz._encode_jit, jax_viz._decode_jit, jax_viz._prior_for_y_jit,
                   jax_viz._get_y_jit):
        cached.cache_clear()


@pytest.fixture
def port_canvases_kept(monkeypatch):
    """The port's canvases by file name, the files written as they are."""
    canvases, write = {}, png.write_png

    def keep(path, canvas):
        canvases[os.path.basename(path)] = np.asarray(canvas, np.float64)
        return write(path, canvas)

    monkeypatch.setattr(port_viz, "write_png", keep)
    return canvases


def _vae_pair(kind, latent=LATENT):
    """(JAX model, params, port model with them) of a tiny VAE-family model."""
    model = {"lgvae": lambda: LGVae(latent, latent, HW),
             "lggmvae": lambda: LGGMVae(latent, latent, HW, Y, 0.4),
             "gmvae": lambda: GMVae(latent, HW, Y, 0.4)}[kind]()
    variables = jax.jit(lambda k: model.init({"params": k, "sample": k},
                                             jnp.zeros((2, *HW, 6)), False))(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, variables["params"])
    port_cfg = PortConfig(model=kind, global_latent_dims=latent, local_latent_dims=latent,
                          y_size=Y)
    return model, params, load_flax_params(get_vae_model(port_cfg, HW, device="cpu"), params)


def _hold_files(dirs, jax_canvases_by_name, port_canvases_by_name):
    """The same names on both sides; canvases at 1e-4; each PNG within one
    8-bit level of the JAX canvas."""
    jax_names = sorted(os.listdir(dirs[0]))
    assert sorted(os.listdir(dirs[1])) == jax_names
    assert sorted(jax_canvases_by_name) == sorted(port_canvases_by_name) == jax_names
    for name in jax_names:
        want, got = jax_canvases_by_name[name], port_canvases_by_name[name]
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        image, _ = png.read_png(os.path.join(dirs[1], name))
        diff = np.abs(image.astype(int) - png.to_uint8(want).astype(int))
        assert diff.max() <= 1, name
    return jax_names


VAE_CASES = {
    # (model, dataset, --viz, batch of the last test step, names at step 5)
    "lgvae_celeba": ("lgvae", "celeba64", False, 20, [
        "generate_it_5.png", "style_transfer_celeba_it_5.png", "vary_lower_it_5.png",
        "vary_upper_it_5.png", "x_hat_reconstruction_test_it_5.png",
        "x_hat_vary_lower_it_5.png", "x_reconstruction_test_it_5.png"]),
    "lggmvae_svhn_viz": ("lggmvae", "svhn", True, 12, None),
    "gmvae_svhn_viz": ("gmvae", "svhn", True, 12, []),
}


@pytest.mark.parametrize("case", list(VAE_CASES))
def test_vae_loop_pngs_match_the_jax_loop(case, tmp_path, monkeypatch, eager_jax_viz,
                                          port_canvases_kept):
    kind, dataset, viz, batch, names = VAE_CASES[case]
    model, params, port = _vae_pair(kind)
    rng = np.random.RandomState(3)
    last_images = rng.uniform(-1, 1, (batch, *HW, 6)).astype(np.float32)
    test_ds = types.SimpleNamespace(images=rng.randint(0, 256, (30, *HW, 3)).astype(np.uint8))
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    for d in dirs:
        os.makedirs(d)
    draws = SeededDraws(monkeypatch)
    jax_cfg = VaeConfig(model=kind, dataset=dataset, viz=viz)
    jax_loop._vae_visualize(jax_cfg, model, params, jax.random.PRNGKey(1), last_images, test_ds,
                            dirs[0], 5)
    noise = draws.noise()
    port_loop._vae_visualize(PortConfig(model=kind, dataset=dataset, viz=viz), port,
                             noise, torch.from_numpy(last_images), test_ds, dirs[1], 5)
    assert noise.exhausted()
    got = _hold_files(dirs, eager_jax_viz, port_canvases_kept)
    if names is not None:
        assert got == names
    else:  # LGGMVae with --viz: the cluster galleries hold the double underscore
        assert {"generate_cluster_it_5.png", "generate_cluster_fix_zl_it_5.png",
                "generate_multi_cluster_it_5.png", "style_transfer_it_5.png"} <= set(got)
        assert any(n.startswith("unseen_cluster__it_5_") for n in got)
        assert len(got) == 10 + sum(n.startswith("unseen_cluster__it_5_") for n in got)


def test_api_parity_writers_match(tmp_path, monkeypatch, eager_jax_viz, port_canvases_kept):
    """generate_traverse (a GMVae with a 2-D latent), plot_latent_dims (LGVae),
    unseen_cluster and unseen_cluster_svhn (GMVae), unseen_cluster_lg_svhn
    (LGGMVae): canvases, latents and names."""
    monkeypatch.setattr(jax_viz, "plt", types.SimpleNamespace(
        figure=lambda *a, **k: None, scatter=lambda *a, **k: None, hist=lambda *a, **k: None,
        close=lambda *a, **k: None, savefig=lambda path, **k: open(path, "wb").close()))
    rng = np.random.RandomState(4)
    images = rng.uniform(-1, 1, (10, *HW, 6)).astype(np.float32)
    test_images = rng.uniform(-1, 1, (30, *HW, 3)).astype(np.float32)
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    for d in dirs:
        os.makedirs(d)
    gm2, p2, port2 = _vae_pair("gmvae", latent=2)
    lg, lg_p, lg_port = _vae_pair("lgvae")
    gm, gm_p, gm_port = _vae_pair("gmvae")
    lgg, lgg_p, lgg_port = _vae_pair("lggmvae")
    draws = SeededDraws(monkeypatch)
    key = jax.random.PRNGKey(2)

    jax_viz.generate_traverse(gm2, p2, filepath=dirs[0], n=4)
    port_viz.generate_traverse(port2, filepath=dirs[1], n=4)
    z_jax = jax_viz.plot_latent_dims(lg, lg_p, [images], key, filepath=dirs[0])
    jax_viz.unseen_cluster(gm, gm_p, images, key, filename="_a", filepath=dirs[0])
    jax_viz.unseen_cluster_svhn(gm, gm_p, test_images, key, filename="_b", filepath=dirs[0])
    jax_viz.unseen_cluster_lg_svhn(lgg, lgg_p, test_images, key, filename="c", filepath=dirs[0])

    noise = draws.noise()
    z_port = port_viz.plot_latent_dims(lg_port, [images], noise, filepath=dirs[1])
    port_viz.unseen_cluster(gm_port, images, noise, filename="_a", filepath=dirs[1])
    port_viz.unseen_cluster_svhn(gm_port, test_images, noise, filename="_b", filepath=dirs[1])
    port_viz.unseen_cluster_lg_svhn(lgg_port, test_images, noise, filename="c",
                                    filepath=dirs[1])
    assert noise.exhausted()
    np.testing.assert_allclose(z_port, np.asarray(z_jax), atol=1e-4)
    latent_names = {"2d_latent_var.png"} | {f"latent_var_{i}.png" for i in range(LATENT)}
    for name in latent_names:  # rasterized scatter and histograms: names and files
        image, _ = png.read_png(os.path.join(dirs[1], name))
        assert image.ndim == 2 and image.max() == 255
        os.remove(os.path.join(dirs[0], name))
        os.remove(os.path.join(dirs[1], name))
    for name in latent_names:
        port_canvases_kept.pop(name)
    got = _hold_files(dirs, eager_jax_viz, port_canvases_kept)
    assert {"latent_space.png", "unseen_cluster_a.png", "unseen_cluster_b.png"} <= set(got)
    assert any(n.startswith("unseen_cluster_c_") for n in got)


# --- SPAIR writers --------------------------------------------------------------------------

class PltStub:
    """Stands in for matplotlib in split_vae_tpu/viz/spair_artifacts.py: keeps
    the arrays each figure hands ``imshow``, by the name it is saved under."""

    def __init__(self):
        self.shown, self.figures = [], {}

    def imshow(self, a, **kwargs):
        self.shown.append(np.asarray(a, np.float64))

    def subplots(self, rows, cols, **kwargs):
        ax = types.SimpleNamespace(imshow=self.imshow, set_title=lambda *a: None,
                                   tick_params=lambda **k: None)
        return None, [ax] * cols

    def savefig(self, path, **kwargs):
        self.figures[os.path.basename(path)], self.shown = self.shown, []

    def figure(self, *a, **k):
        pass

    def axis(self, *a, **k):
        pass

    def close(self, *a, **k):
        pass


def _spair_output(glimpse_local: bool, b=3, grid=2, os_=8, hw=16):
    """One seeded output of either shape, as numpy arrays by field."""
    rng = np.random.RandomState(5)
    k = grid * grid

    def u(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    lo = rng.uniform(0, 0.6, (b, k, 2))
    bbox = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, (b, k, 2))], -1).astype(np.float32)
    bbox[0, 0] = 0.0
    out = dict(
        x_recon=u(b, hw, hw, 3), z_what=u(b, grid, grid, 4), z_what_mean=u(b, grid, grid, 4),
        z_what_sigma=u(b, grid, grid, 4), z_where=u(b, grid, grid, 4, lo=-2, hi=2),
        z_where_mean=u(b, grid, grid, 4), z_where_sigma=u(b, grid, grid, 4),
        z_depth=u(b, grid, grid, 1, lo=-3, hi=3), z_depth_mean=u(b, grid, grid, 1),
        z_depth_sigma=u(b, grid, grid, 1), z_pres=u(b, grid, grid, 1),
        z_pres_logits=u(b, grid, grid, 1, lo=-4, hi=4),
        z_pres_pre_sigmoid=u(b, grid, grid, 1, lo=-4, hi=4),
        all_glimpses=u(b, k, os_, os_, 3), obj_recon_unnorm=u(b, k, os_, os_, 3),
        obj_recon_alpha=u(b, k, os_, os_, 1), obj_full_recon_unnorm=u(b, k, hw, hw, 4, hi=1.2),
        obj_bbox_mask=bbox)
    if glimpse_local:
        out.update(x_hat=u(b, k, os_, os_, 3), x_hat_recon=u(b, k, os_, os_, 3))
    else:
        out.update(x_hat_recon=u(b, hw, hw, 3, lo=-0.1, hi=1.1))
    return out, u(b, hw, hw, 6)


SPAIR_WRITERS = [
    ("reconstruction_test", False, "x_reconstrcution_test_s.png"),
    ("reconstruction_bbox", False, "x_reconstrcution_bbox_s.png"),
    ("glimpses_reconstruction_test", False, "glimpses_s.png"),
    ("glimpses_local_reconstruction_test", True, "glimpses_local_s.png"),
    ("x_hat_reconstruction_test", False, "x_hat_reconstrcution_test_s.png"),
    ("train_decomposition_plot", False, "train_recon_it__s.png"),
]


@pytest.mark.parametrize("writer, glimpse_local, name", SPAIR_WRITERS,
                         ids=[w for w, _, _ in SPAIR_WRITERS])
def test_spair_writer_matches(writer, glimpse_local, name, tmp_path, monkeypatch):
    fields, images = _spair_output(glimpse_local)
    jax_out = SpairOutput(**{k: jnp.asarray(v) for k, v in fields.items()})
    port_out = PortSpairOutput(**{k: torch.from_numpy(v) for k, v in fields.items()})
    stub = PltStub()
    monkeypatch.setattr(jax_sviz, "plt", stub)
    monkeypatch.setattr(jax_sviz, "_forward", lambda *a: jax_out)
    monkeypatch.setattr(port_sviz, "_forward", lambda *a: port_out)
    if writer == "train_decomposition_plot":
        jax_sviz.train_decomposition_plot(images, jax_out, filename="_s", filepath=str(tmp_path))
        got = port_sviz.train_decomposition_plot(torch.from_numpy(images), port_out,
                                                 filename="_s", filepath=str(tmp_path))
        want = stub.figures[name][0]  # its first panel, clipped to [0, 1]
        got = np.clip(got, 0, 1)
    else:
        want = getattr(jax_sviz, writer)(None, None, images, None, filename="_s",
                                         filepath=str(tmp_path))
        got = getattr(port_sviz, writer)(None, torch.from_numpy(images), Noise(torch.Generator()),
                                         filename="_s", filepath=str(tmp_path))
    np.testing.assert_allclose(got, np.squeeze(want) if got.ndim < 3 else want, atol=1e-6)
    assert os.listdir(tmp_path) == [name]
    image, _ = png.read_png(str(tmp_path / name))
    np.testing.assert_array_equal(
        image, png.join_panels([png.to_uint8(a) for a in stub.figures[name]]))


def _tiny_spair(model, **extra):
    cfg = PortSpairConfig(model=model, batch_size=2, latent_size=4, bg_latent_size=4,
                          local_latent_size=4, object_size=8, patch_size=4,
                          image_size=(24, 24, 3), **extra)
    return cfg, get_spair_model(cfg, device="cpu")


@pytest.mark.parametrize("model, extra, last", [
    ("lg_spair", dict(split_z_l=True, concat_z_what=True), "x_hat_reconstrcution_test"),
    ("lg_glimpse_spair", {}, "glimpses_local"),
], ids=["lg_spair", "lg_glimpse_spair"])
def test_spair_loop_png_names_match_the_jax_loop(model, extra, last, tmp_path):
    """One eval at step 7 with two test sets through the port loop's two
    functions; the names split_vae_tpu/train/loop.py:343-389 writes: the train
    decomposition ``train_recon_it_<s>`` (:350-352), then for each test set
    ``_it_<s>_<n>`` of the three writers (:375-380) and of LG-SPAIR's
    ``x_hat_reconstrcution_test`` (:381-383) or LGGlimpseSPAIR's
    ``glimpses_local`` (:384-387)."""
    cfg, net = _tiny_spair(model, **extra)
    gen = torch.Generator().manual_seed(0)
    batch = torch.rand((2, 24, 24, 3), generator=gen)
    eval_step = make_spair_eval_step(cfg, net)
    port_loop._spair_train_plot(eval_step, gen, batch, str(tmp_path), 7)
    for test_num in (0, 1):
        _, _, images = eval_step(gen, batch)
        port_loop._spair_visualize(net, images, Noise(gen), str(tmp_path), f"_it_7_{test_num}")
    want = ["train_recon_it_7.png"] + [
        f"{stem}_it_7_{n}.png" for n in (0, 1)
        for stem in ("x_reconstrcution_test", "x_reconstrcution_bbox", "glimpses", last)]
    assert sorted(os.listdir(tmp_path)) == sorted(want)
    for name in want:
        image, header = png.read_png(str(tmp_path / name))
        assert image.ndim == 3 and image.shape[2] == 3, name
