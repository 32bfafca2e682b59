"""Parameter conversion (split_vae_torch.interop.flax_params) and the port's
independence from JAX.

Every leaf of a flax tree of each SPAIR model and of LGVae converts into the
port's state_dict and back unchanged; a leaf with no counterpart on either side
raises; the port initialises every family that train/loop.py builds (the
four SPAIR models, LGVae, LGGMVae, GMVae and the probe classifier) by the JAX
package's scheme; and no module of the port, nor chip_smoke.py, quality_runs_torch.py,
crop_layer_turns.py or bf16_turns.py, imports jax, flax, optax, msgpack, the JAX package, its
research tools, matplotlib or PIL (the real datasets' JPEG readers alone
import PIL).
"""

import ast
import os
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.core.config import SpairConfig as PortConfig  # noqa: E402
from split_vae_torch.core.config import config5  # noqa: E402
from split_vae_torch.interop.flax_params import (  # noqa: E402
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)
from split_vae_torch.core.config import (  # noqa: E402
    CONFIG2_IMAGE_HW,
    CONFIG3_IMAGE_HW,
    config2,
    config3,
    config_bg_spair,
    config_glimpse_spair,
)
from split_vae_torch.nn.classifier import Classifier as TorchClassifier  # noqa: E402
from split_vae_torch.nn.common import BatchNorm, Conv, Dense, init_params  # noqa: E402
from split_vae_torch.models.spair import get_spair_model as torch_model  # noqa: E402
from split_vae_torch.models.vae import get_vae_model as torch_vae_model  # noqa: E402
from split_vae_tpu.core.config import SpairConfig  # noqa: E402
from split_vae_tpu.models.spair import get_spair_model as jax_model  # noqa: E402
from split_vae_tpu.models.vae import LGVae as JaxLGVae  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(batch_size=2, latent_size=8, bg_latent_size=8, local_latent_size=8,
             object_size=16)


def _flax_params():
    cfg = SpairConfig(**{**config5().__dict__, **SMALL})
    cfg.image_size = (24, 24, 3)
    variables = jax_model(cfg).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((2, 24, 24, 6)), training=True)
    params = jax.tree.map(np.asarray, variables["params"])
    port_cfg = config5(**SMALL)
    port_cfg.image_size = (24, 24, 3)
    return params, torch_model(port_cfg, device="cpu")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_every_leaf_converts_and_round_trips():
    params, model = _flax_params()
    load_flax_params(model, params)
    sd = model.state_dict()
    # Layouts: a conv kernel HWIO -> OIHW, a Dense kernel [in, out] -> [out, in].
    np.testing.assert_array_equal(sd["encoder.conv1.weight"].numpy(),
                                  params["encoder"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["encoder.where_d1.weight"].numpy(),
                                  params["encoder"]["where_d1"]["kernel"].T)
    back = dict(_flat(state_dict_to_flax(sd)))
    want = dict(_flat(params))
    assert sorted(back) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], leaf, err_msg="/".join(path))


FAMILY = {
    "spair": dict(model="spair"),
    "bg_spair": dict(model="bg_spair"),
    "lg_glimpse_spair": dict(model="lg_glimpse_spair", object_size=12, patch_size=4),
    "lg_glimpse_spair_dense_bg": dict(model="lg_glimpse_spair", dense_bg=True),
    "lg_spair_conv": dict(model="lg_spair", concat_z_what=True),
    "lg_spair_concat": dict(model="lg_spair", concat_z_bg=True, concat_backbone=True,
                            dense_bg=True),
}
# For three models: a scope whose absence must raise, and a leaf the state_dict must hold.
NEW_MODULES = {
    "bg_spair": ("bg_model", "bg_model.Conv_6.weight"),
    "lg_glimpse_spair": ("x_hat_decoder", "encoder.obj_encoder.local_sigma.weight"),
    "lg_spair_conv": ("x_hat_encoder", "bg_decoder.Conv_3.bias"),
}


def _family_params(variant):
    port_cfg = PortConfig(**{**SMALL, "image_size": (24, 24, 3), **FAMILY[variant]})
    c = 6 if port_cfg.model == "lg_spair" else 3
    variables = jax_model(SpairConfig(**port_cfg.__dict__)).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((2, 24, 24, c)), training=True)
    return jax.tree.map(np.asarray, variables["params"]), torch_model(port_cfg, device="cpu")


@pytest.mark.parametrize("variant", list(FAMILY))
def test_family_leaves_convert_and_round_trip(variant):
    params, model = _family_params(variant)
    load_flax_params(model, params)
    back = dict(_flat(state_dict_to_flax(model.state_dict())))
    want = dict(_flat(params))
    assert sorted(back) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], leaf, err_msg="/".join(path))


@pytest.mark.parametrize("variant", list(NEW_MODULES))
def test_family_unmapped_leaves_raise(variant):
    params, model = _family_params(variant)
    scope, leaf = NEW_MODULES[variant]
    assert leaf in model.state_dict()
    short = {k: v for k, v in params.items() if k != scope}
    with pytest.raises(KeyError, match=scope):
        flax_to_state_dict(short, model)
    extra = {**params, scope: {**params[scope], "Dense_9": {"bias": np.zeros(2, np.float32)}}}
    with pytest.raises(KeyError, match="Dense_9"):
        flax_to_state_dict(extra, model)


def _lgvae_params(hw):
    cfg = config2(global_latent_dims=8, local_latent_dims=6)
    variables = JaxLGVae(cfg.global_latent_dims, cfg.local_latent_dims, hw).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((2, *hw, 6)))
    return jax.tree.map(np.asarray, variables["params"]), torch_vae_model(cfg, hw, device="cpu")


@pytest.mark.parametrize("hw", [(32, 32), (64, 64)])
def test_lgvae_leaves_convert_and_round_trip(hw):
    params, model = _lgvae_params(hw)
    load_flax_params(model, params)
    sd = model.state_dict()
    # The 6x6 kernel of the decoder's resize+conv layer keeps the flax name Conv_3.
    np.testing.assert_array_equal(sd["decoder_x.Conv_3.weight"].numpy(),
                                  params["decoder_x"]["Conv_3"]["kernel"].transpose(3, 2, 0, 1))
    assert tuple(sd["decoder_x.Conv_3.weight"].shape) == (6, 32, 6, 6)
    assert tuple(sd["decoder_x.Dense_0.weight"].shape)[1] == 8 + 6
    back = dict(_flat(state_dict_to_flax(sd)))
    want = dict(_flat(params))
    assert sorted(back) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], leaf, err_msg="/".join(path))


@pytest.mark.parametrize("scope", ["encoder_x", "encoder_x_hat", "decoder_x", "decoder_x_hat"])
def test_lgvae_unmapped_leaves_raise(scope):
    params, model = _lgvae_params((32, 32))
    short = {k: v for k, v in params.items() if k != scope}
    with pytest.raises(KeyError, match=scope):
        flax_to_state_dict(short, model)
    extra = {**params, scope: {**params[scope], "Conv_9": {"bias": np.zeros(2, np.float32)}}}
    with pytest.raises(KeyError, match="Conv_9"):
        flax_to_state_dict(extra, model)
    wrong = {**params, scope: {**params[scope],
                               "Dense_0": {**params[scope]["Dense_0"],
                                           "bias": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="Dense_0"):
        flax_to_state_dict(wrong, model)


def test_unmapped_leaves_raise():
    params, model = _flax_params()
    extra = {**params, "stray": {"Dense_9": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(KeyError, match="stray"):
        flax_to_state_dict(extra, model)
    short = {k: v for k, v in params.items() if k != "bg_decoder"}
    with pytest.raises(KeyError, match="bg_decoder"):
        flax_to_state_dict(short, model)
    wrong = jax.tree.map(lambda a: a, params)
    wrong["encoder"]["z3"]["bias"] = np.zeros((7,), np.float32)
    with pytest.raises(ValueError, match="z3"):
        flax_to_state_dict(wrong, model)


def test_port_init_matches_flax_scheme():
    """Glorot-uniform weights and zero biases, as the JAX package draws them."""
    params, model = _flax_params()
    for name, t in model.state_dict().items():
        if name.endswith("bias"):
            assert torch.count_nonzero(t) == 0, name
        else:
            fan_in = t.shape[1] * t[0, 0].numel()
            fan_out = t.shape[0] * t[0, 0].numel()
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            assert t.abs().max() <= limit and t.abs().max() > 0.5 * limit, name


def _ones_bias_layers():
    """The layers whose bias the JAX package starts at 1 (``bias_init=ones_bias``),
    read from its source: the GM encoder's two sigma heads."""
    names = set()
    folder = os.path.join(REPO, "split_vae_tpu", "nn")
    for f in sorted(os.listdir(folder)):
        if f.endswith(".py"):
            with open(os.path.join(folder, f)) as src:
                names |= set(re.findall(r"self\.(\w+) = Dense\([^)]*bias_init=ones_bias",
                                        src.read()))
    return names


def _family_model(family):
    """The model train/loop.py builds for ``family``, at its full width, as the
    loop initialises it (the classifier as train/probes.py::train_classifier
    does)."""
    if family in SPAIR_FAMILIES:
        return torch_model(SPAIR_FAMILIES[family](), device="cpu")
    if family in VAE_FAMILIES:
        cfg, hw = VAE_FAMILIES[family]
        return torch_vae_model(cfg(), hw, device="cpu")
    model = TorchClassifier(device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    return model


SPAIR_FAMILIES = {"lg_spair": config5, "spair": lambda: PortConfig(model="spair"),
                  "bg_spair": config_bg_spair, "lg_glimpse_spair": config_glimpse_spair}
VAE_FAMILIES = {"lgvae": (config2, CONFIG2_IMAGE_HW), "lggmvae": (config3, CONFIG3_IMAGE_HW),
                "gmvae": (lambda: config3(model="gmvae"), CONFIG3_IMAGE_HW)}


@pytest.mark.parametrize("family", [*SPAIR_FAMILIES, *VAE_FAMILIES, "classifier"])
def test_port_init_matches_flax_scheme_for_every_family(family):
    """Every Dense and Conv glorot-uniform within glorot's limit, which a leaf
    of 1024 elements or more reaches (above 0.9 of it) with its sample
    standard deviation within 10% of limit/sqrt(3); every bias 0 but the JAX
    package's ``ones_bias`` layers' 1; BatchNorm's scale 1, bias 0, mean 0 and
    variance 1, as flax starts them."""
    ones = _ones_bias_layers()
    assert ones == {"z_prior_sig_head", "z_sig_head"}
    model = _family_model(family)
    held = set()
    for layer_name, layer in model.named_modules():
        if isinstance(layer, (Dense, Conv)):
            w = layer.weight.detach().double()
            fan_in = w.shape[1] * w[0, 0].numel()
            fan_out = w.shape[0] * w[0, 0].numel()
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            top = float(w.abs().max())
            assert top <= limit, layer_name
            if w.numel() >= 1024:
                assert top > 0.9 * limit, layer_name
                std = float(w.std())
                assert abs(std - limit / np.sqrt(3.0)) <= 0.1 * limit / np.sqrt(3.0), \
                    f"{layer_name}: std {std:.4g}, glorot {limit / np.sqrt(3.0):.4g}"
            want = 1.0 if layer_name.rsplit(".", 1)[-1] in ones else 0.0
            assert torch.all(layer.bias == want), layer_name
        elif isinstance(layer, BatchNorm):
            for t, want in ((layer.weight, 1.0), (layer.bias, 0.0), (layer.running_mean, 0.0),
                            (layer.running_var, 1.0)):
                assert torch.all(t == want), layer_name
        else:
            continue
        held |= {f"{layer_name}.{n}" for n, _ in layer.named_parameters(recurse=False)}
    assert held == {n for n, _ in model.named_parameters()}
    if family in ("lggmvae", "gmvae"):
        assert any(torch.all(p == 1.0) for n, p in model.named_parameters()
                   if n.endswith("sig_head.bias"))


def test_entry_point_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_model(config5(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_vae_model(config2(), (64, 64))


def _sources():
    for root, _, files in os.walk(os.path.join(REPO, "split_vae_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "quality_runs_torch.py")
    yield os.path.join(REPO, "crop_layer_turns.py")
    yield os.path.join(REPO, "bf16_turns.py")


# The readers of the real datasets' JPEG files, which the card's machine does not
# hold, import PIL inside the function that decodes them (as the JAX package's
# readers do); nothing else of the port may, and the figures need neither PIL
# nor matplotlib (split_vae_torch/viz/png.py writes the PNG files).
PIL_READERS = ("data/celeba.py", "data/multicub.py", "data/native.py")


@pytest.mark.parametrize("banned", ["jax", "flax", "optax", "msgpack", "split_vae_tpu",
                                    "tools", "matplotlib", "PIL"])
def test_port_imports_no_jax(banned):
    for path in _sources():
        if banned == "PIL" and path.endswith(PIL_READERS):
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] != banned, f"{path} imports {name}"
