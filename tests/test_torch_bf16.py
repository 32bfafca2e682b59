"""``--compute_dtype bfloat16`` in the port: bfloat16 activations from every
Dense and Conv, float32 parameters, geometry, render composite and losses.

The JAX package's contract (tests/test_bf16_mode.py), ported: the parameters
stay float32 after a bfloat16 step; one LG-SPAIR and one LGVae step (and,
beyond it, one LGGMVae step) in bfloat16 give a finite loss within rtol 0.02
of the float32 step's;
``zwhere_to_params`` gives float32 from bfloat16; and (the intent of the JAX
step's ``_check_activation_dtype``) a step refuses a model built in the other
dtype.

Against the JAX package in bfloat16 (``set_activation_dtype("bfloat16")``,
restored to float32 whatever happens): the dtype of every output field of
LG-SPAIR, LGVae, LGGMVae and of the probe classifier's logits is the JAX
package's; one Dense and one Conv lie within one bfloat16 ulp of flax's; the
LG-SPAIR, LGVae and LGGMVae forwards agree field by field within 3e-2 of the field's
largest magnitude (a few bfloat16 ulps, 2^-8 relative each: the two packages
round the same float32 sums to bfloat16 after every layer, a sum in another
order now and then one ulp apart, and those ulps travel through the later
layers). Both sides draw from one seeded numpy stream
(``test_torch_viz.py::SeededDraws``), the JAX forward jitted.
"""

import pytest

torch = pytest.importorskip("torch")

import flax.linen as flax_nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import split_vae_tpu.models.spair as jax_spair  # noqa: E402
from split_vae_torch.core.config import SpairConfig as PortSpairConfig  # noqa: E402
from split_vae_torch.core.config import VaeConfig as PortVaeConfig  # noqa: E402
from split_vae_torch.core.state import create_train_state  # noqa: E402
from split_vae_torch.interop.flax_params import load_flax_params  # noqa: E402
from split_vae_torch.models.spair import get_spair_model  # noqa: E402
from split_vae_torch.models.vae import get_vae_model  # noqa: E402
from split_vae_torch.nn.classifier import Classifier  # noqa: E402
from split_vae_torch.nn.common import Conv, Dense  # noqa: E402
from split_vae_torch.ops import stn  # noqa: E402
from split_vae_torch.train.loop import build_vae_model  # noqa: E402
from split_vae_torch.train.optim import spair_optimizer, vae_optimizer  # noqa: E402
from split_vae_torch.train.steps import make_spair_train_step, make_vae_train_step  # noqa: E402
from split_vae_tpu.core.config import SpairConfig  # noqa: E402
from split_vae_tpu.models.vae import LGGMVae, LGVae  # noqa: E402
from split_vae_tpu.nn.classifier import Classifier as JaxClassifier  # noqa: E402
from split_vae_tpu.nn.common import set_activation_dtype  # noqa: E402
from tests.test_torch_viz import SeededDraws  # noqa: E402

BF16_TOL = 3e-2  # of the field's largest magnitude


@pytest.fixture
def jax_bf16():
    set_activation_dtype("bfloat16")
    try:
        yield
    finally:
        set_activation_dtype("float32")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these small CPU steps run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the JAX package's contract, on the port ------------------------------------------------

SPAIR_STEP = dict(model="lg_spair", batch_size=8, latent_size=16, bg_latent_size=8,
                  local_latent_size=8, patch_size=8, split_z_l=True, concat_z_what=True,
                  dense_bg=True, dense_local=True, image_size=(48, 48, 3))


def _spair_step(dtype):
    cfg = PortSpairConfig(**SPAIR_STEP, compute_dtype=dtype)
    state = create_train_state(get_spair_model(cfg, device="cpu"), spair_optimizer(1e-4))
    x = torch.from_numpy(np.random.RandomState(0).rand(8, 48, 48, 3).astype(np.float32))
    state, m = make_spair_train_step(cfg)(state, x)
    return float(m["total_loss"]), float(m["notfinite_updates"]), state


def _vae_step(dtype):
    cfg = PortVaeConfig(model="lgvae", batch_size=8, patch_size=2, beta=1.0,
                        global_latent_dims=8, local_latent_dims=8, no_label=True,
                        compute_dtype=dtype)
    state = create_train_state(get_vae_model(cfg, (64, 64), device="cpu"), vae_optimizer(1e-4))
    raw = torch.from_numpy(np.random.RandomState(0).randint(0, 255, (8, 64, 64, 3), np.uint8))
    state, m = make_vae_train_step(cfg)(state, raw)
    return float(m["total_loss"]), float(m["notfinite_updates"]), state


def _gm_step(dtype):
    """LGGMVae (beyond the JAX package's contract): the Gumbel softmax, the
    dropout and AMSGrad's state in a bf16 step."""
    cfg = PortVaeConfig(model="lggmvae", batch_size=8, patch_size=4, global_latent_dims=8,
                        local_latent_dims=8, y_size=5, no_label=True, compute_dtype=dtype)
    model, tx = build_vae_model(cfg, (32, 32), device="cpu")
    state = create_train_state(model, tx)
    raw = torch.from_numpy(np.random.RandomState(0).randint(0, 255, (8, 32, 32, 3), np.uint8))
    state, m = make_vae_train_step(cfg)(state, raw)
    return float(m["total_loss"]), float(m["notfinite_updates"]), state


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)


@pytest.mark.parametrize("step", [_spair_step, _vae_step, _gm_step],
                         ids=["lg_spair", "lgvae", "lggmvae"])
def test_bf16_step_close_to_f32_and_params_stay_f32(step):
    f32, _, _ = step("float32")
    bf16, skipped, state = step("bfloat16")
    assert np.isfinite(bf16) and skipped == 0.0
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    moments = [t for t in _tensors(state.opt_state) if t.is_floating_point()]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    np.testing.assert_allclose(bf16, f32, rtol=0.02)


def test_stn_geometry_stays_f32():
    params = stn.zwhere_to_params(torch.zeros((2, 4, 4, 4), dtype=torch.bfloat16))
    assert all(v.dtype == torch.float32 for v in params)


@pytest.mark.parametrize("model_dtype, step_dtype", [("float32", "bfloat16"),
                                                     ("bfloat16", "float32")])
def test_step_refuses_a_model_of_the_other_dtype(model_dtype, step_dtype):
    cfg = PortSpairConfig(**{**SPAIR_STEP, "batch_size": 2, "dense_bg": False,
                             "dense_local": False, "image_size": (24, 24, 3),
                             "object_size": 16}, compute_dtype=model_dtype)
    state = create_train_state(get_spair_model(cfg, device="cpu"), spair_optimizer(1e-4))
    step = make_spair_train_step(cfg.replace(compute_dtype=step_dtype))
    with pytest.raises(ValueError, match="compute dtype mismatch"):
        step(state, torch.zeros((2, 24, 24, 3)))


# --- against the JAX package in bfloat16 ----------------------------------------------------

def _ulps(a, b):
    """|a - b| in bfloat16 ulps of the larger magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return np.abs(a - b) / ulp


@pytest.mark.parametrize("layer", ["dense", "conv"])
def test_dense_and_conv_within_one_ulp_of_flax(layer, jax_bf16):
    rng = np.random.RandomState(1)
    if layer == "dense":
        x = rng.standard_normal((16, 40)).astype(np.float32)
        flax_layer, port = flax_nn.Dense(24, dtype=jnp.bfloat16), Dense(40, 24,
                                                                        dtype=torch.bfloat16)
    else:
        x = rng.standard_normal((2, 9, 9, 5)).astype(np.float32)
        flax_layer = flax_nn.Conv(7, (3, 3), strides=2, padding="SAME", dtype=jnp.bfloat16)
        port = Conv(5, 7, (3, 3), stride=2, dtype=torch.bfloat16)
    variables = flax_layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree.map(lambda v: v + 0.1, variables)  # biases off zero
    load_flax_params(port, jax.tree.map(np.asarray, variables["params"]))
    want = flax_layer.apply(variables, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    ulps = _ulps(got.float().detach().numpy(), np.asarray(want, np.float32))
    assert ulps.max() <= 1.0, ulps.max()


def _np32(t):
    return t.float().detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _hold_fields(want, got):
    """Every field's dtype, and its values within BF16_TOL of its max (the
    largest gap measured is 1.6e-2, LG-SPAIR's z_what_mean)."""
    assert got._fields == want._fields
    for field in want._fields:
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is None:
            continue
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), (field, g.dtype, w.dtype)
        w32, g32 = np.asarray(w, np.float32), _np32(g)
        scale = max(float(np.abs(w32).max()), 1e-12)
        assert np.abs(g32 - w32).max() <= BF16_TOL * scale, (
            field, float(np.abs(g32 - w32).max()) / scale)


SPAIR_SMALL = dict(model="lg_spair", batch_size=2, latent_size=8, bg_latent_size=8,
                   local_latent_size=8, object_size=16, patch_size=8, split_z_l=True,
                   concat_z_what=True, image_size=(24, 24, 3))


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_lg_spair_forward_matches_jax_in_bf16(training, jax_bf16, monkeypatch):
    """The unfused forward (the JAX package's on the CPU); its render
    composite and geometry in float32 on both sides."""
    jax_cfg = SpairConfig(**SPAIR_SMALL)
    model = jax_spair.get_spair_model(jax_cfg)
    x = np.random.RandomState(2).uniform(0, 1, (2, 24, 24, 6)).astype(np.float32)
    variables = jax.jit(lambda k: model.init({"params": k, "sample": k}, jnp.asarray(x),
                                             training=True))(jax.random.PRNGKey(0))
    draws = SeededDraws(monkeypatch)
    want = jax.jit(lambda v, xx: model.apply(v, xx, training, fused=False,
                                             rngs={"sample": jax.random.PRNGKey(1)}))(
        variables, jnp.asarray(x))
    port = load_flax_params(
        get_spair_model(PortSpairConfig(**SPAIR_SMALL, compute_dtype="bfloat16"), device="cpu"),
        jax.tree.map(np.asarray, variables["params"]))
    noise = draws.noise()
    with torch.no_grad():
        got = port(torch.from_numpy(x), training, noise, fused=False)
    assert noise.exhausted()
    _hold_fields(want, got)
    assert got.x_recon.dtype == got.obj_full_recon_unnorm.dtype == torch.float32
    assert got.z_what.dtype == got.obj_recon_unnorm.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["lgvae", "lggmvae"])
def test_vae_forward_matches_jax_in_bf16(kind, jax_bf16, monkeypatch):
    hw = (16, 16)
    model = LGVae(8, 8, hw) if kind == "lgvae" else LGGMVae(8, 8, hw, 5, 0.4)
    x = np.random.RandomState(3).uniform(-1, 1, (4, *hw, 6)).astype(np.float32)
    variables = jax.jit(lambda k: model.init({"params": k, "sample": k, "dropout": k},
                                             jnp.asarray(x), False))(jax.random.PRNGKey(0))
    draws = SeededDraws(monkeypatch)
    want = jax.jit(lambda v, xx: model.apply(v, xx, False,
                                             rngs={"sample": jax.random.PRNGKey(1)}))(
        variables, jnp.asarray(x))
    cfg = PortVaeConfig(model=kind, global_latent_dims=8, local_latent_dims=8, y_size=5,
                        compute_dtype="bfloat16")
    port = load_flax_params(get_vae_model(cfg, hw, device="cpu"),
                            jax.tree.map(np.asarray, variables["params"]))
    noise = draws.noise()
    with torch.no_grad():
        got = port(torch.from_numpy(x), False, noise)
    assert noise.exhausted()
    _hold_fields(want, got)


def test_probe_classifier_logits_dtype_matches_jax_in_bf16(jax_bf16):
    x = np.random.RandomState(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jax_model = JaxClassifier(256, 10)
    variables = jax.jit(lambda k: jax_model.init({"params": k, "dropout": k}, jnp.asarray(x),
                                                 False))(jax.random.PRNGKey(0))
    want = jax_model.apply(variables, jnp.asarray(x), False)
    port = load_flax_params(Classifier(dtype=torch.bfloat16),
                            jax.tree.map(np.asarray, variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x), False)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np32(got), np.asarray(want, np.float32),
                               atol=BF16_TOL * float(np.abs(np.asarray(want, np.float32)).max()))
