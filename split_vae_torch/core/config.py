"""Typed configuration: the JAX package's VaeConfig and SpairConfig, field for field.

Same fields and defaults as ``split_vae_tpu/core/config.py`` (BaseConfig,
VaeConfig, SpairConfig and ClassifierConfig), with the reference CLIs' parsers
``parse_vae_args`` and ``parse_spair_args``. ``config5``
gives BASELINE config #5 (LG-SPAIR on Multi-Bird-Hard) as
``bench.py::measure_spair`` sets it, ``config5_glimpse`` config #5's flags
with the glimpse-local model (LGGlimpseSPAIR), ``config2`` BASELINE config #2 (LGVae on
CelebA 64x64) as ``bench.py::measure`` sets it, ``config3`` BASELINE config #3
(SPLIT-GMVAE on SVHN 32x32), ``config4`` BASELINE config #4 (SPLIT-GMVAE on
CelebA 64x64); ``config_bg_spair`` and
``config_glimpse_spair`` give two more full-width configurations at the
SpairConfig defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class BaseConfig:
    seed: int = 0
    data_dir: str = "data"
    output_dir: str = "output"
    eval_interval: Optional[int] = None
    checkpoint_interval: int = 10000
    resume: Optional[str] = None
    num_data_shards: int = 0
    num_model_shards: int = 1
    compute_dtype: str = "float32"  # or "bfloat16"
    profile_dir: Optional[str] = None
    debug_nans: bool = False
    log_every: int = 100
    synthetic_data: bool = False
    synthetic_size: int = 0
    synthetic_style: str = "blobs"
    platform: Optional[str] = None
    host_data: bool = False
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class VaeConfig(BaseConfig):
    """vae/main.py:15-31 flag set."""

    viz: bool = False
    global_latent_dims: int = 128
    local_latent_dims: int = 128
    learning_rate: float = 1e-4
    beta: float = 40.0
    dataset: str = "svhn"
    training_steps: int = 1_000_000
    batch_size: int = 64
    patch_size: int = 1
    augmentation: str = "scramble"
    no_label: bool = False
    model: str = "lgvae"
    y_size: int = 30
    tau: float = 0.4
    alpha: float = 40.0

    @property
    def label(self) -> bool:
        return not self.no_label

    def __post_init__(self):
        if self.eval_interval is None:
            self.eval_interval = 10_000


@dataclass
class SpairConfig(BaseConfig):
    """spair/main.py:19-50 flag set (+ the reference's phantom options)."""

    learning_rate: float = 1e-4
    beta: float = 0.5
    dataset: str = "cub_solid_fixed"
    channel: int = 3
    training_steps: int = 100_000
    batch_size: int = 32
    runs: int = 1
    tau: float = 0.8
    object_size: int = 32
    latent_size: int = 128
    no_label: bool = False
    anneal_until: float = 1.0
    z_pres_anneal_step: float = 10_000.0
    prior_z_zoom: float = 0.0
    prior_z_zoom_start: float = 10.0
    reconstruction_weight: float = 1.0
    bg_latent_size: int = 4
    local_latent_size: int = 64
    z_bg_beta: float = 10.0
    z_l_beta: float = 0.1
    z_what_beta: float = 0.1
    model: str = "spair"
    patch_size: int = 4
    augmentation: str = "scramble"
    split_z_l: bool = False
    dense_bg: bool = False
    dense_local: bool = False
    concat_bg: bool = False
    concat_z_what: bool = False
    concat_backbone: bool = False
    bg_model: bool = False
    concat_z_bg: bool = False
    # The fused paste+composite render (the CUDA kernel pair on a GPU).
    fused_render: bool = True
    no_fused_render: bool = False
    interpret_fused: bool = False

    # [H, W, C]
    image_size: Tuple[int, int, int] = (48, 48, 3)
    test_size: Tuple[int, int, int] = (48, 48, 3)

    @property
    def label(self) -> bool:
        return not self.no_label

    def __post_init__(self):
        if self.eval_interval is None:
            self.eval_interval = 1_000


@dataclass
class ClassifierConfig(BaseConfig):
    """vae/classifier.py:30-31 hard-coded config."""

    learning_rate: float = 1e-4
    latent_dims: int = 256
    dataset: str = "svhn"
    epochs: int = 20
    batch_size: int = 32


_FLAG_STYLE = {
    # Flags spelled with a single dash + store_true in the reference.
    "viz", "no_label", "allow_growth", "split_z_l", "dense_bg", "dense_local",
    "concat_bg", "concat_z_what", "concat_backbone", "synthetic_data",
    "debug_nans", "bg_model", "concat_z_bg", "fused_render", "no_fused_render",
    "host_data",
}
# Counts parse through float, so 1e5 is accepted. The JAX parser converts
# them so only after argparse, which has already refused "1e5" for a field
# with an int default (training_steps, checkpoint_interval).
_COUNT_FIELDS = ("training_steps", "eval_interval", "checkpoint_interval", "num_processes",
                 "process_id")


def _count(value: str) -> int:
    return int(float(value))


def _add_fields(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        if f.name in ("image_size", "test_size"):
            continue
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool) or isinstance(default, bool):
            prefix = "-" if f.name in _FLAG_STYLE else "--"
            parser.add_argument(f"{prefix}{f.name}", action="store_true", default=default)
        else:
            if f.name in _COUNT_FIELDS:
                typ = _count
            elif default is None:
                typ = str
            else:
                typ = {int: int, float: float}.get(type(default), str)
            parser.add_argument(f"--{f.name}", type=typ, nargs="?", default=default)


def _parse(cls, description: str, argv) -> dict:
    parser = argparse.ArgumentParser(description=description)
    _add_fields(parser, cls)
    parser.add_argument("-allow_growth", action="store_true")  # accepted, ignored (TF-ism)
    ns = vars(parser.parse_args(argv))
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in ns.items() if k in names}


def parse_vae_args(argv=None) -> VaeConfig:
    return VaeConfig(**_parse(VaeConfig, "SPLIT-VAE training (PyTorch)", argv))


def parse_spair_args(argv=None) -> SpairConfig:
    cfg = SpairConfig(**_parse(SpairConfig, "SPLIT-SPAIR training (PyTorch)", argv))
    if cfg.no_fused_render:
        cfg.fused_render = False
    size = 48  # MultiCUB canvas (spair/data.py:239-247)
    cfg.image_size = (size, size, cfg.channel)
    cfg.test_size = (size, size, cfg.channel)
    return cfg


# BASELINE config #5: LG-SPAIR, Multi-Bird-Hard (bench.py:114-119).
CONFIG5 = dict(
    model="lg_spair", dataset="cub_ckb_rot_6", batch_size=256,
    latent_size=64, bg_latent_size=64, local_latent_size=64,
    z_bg_beta=1.0, z_what_beta=0.5, patch_size=8, split_z_l=True,
    concat_z_what=True, dense_local=True, dense_bg=True, fused_render=True)


def config5(**overrides) -> SpairConfig:
    return SpairConfig(**{**CONFIG5, **overrides})


# Config #5's published flags with the glimpse-local model: the README's
# config #5 command (``CONFIG5G_ARGV``) with ``--model lg_glimpse_spair``, at
# config #5's batch of 256 (the CLI's default is 32). ``split_z_l``,
# ``dense_local`` and ``concat_z_what`` are LG-SPAIR's and inert here, as is
# ``z_l_beta`` (the loss weighs z_l inside the concat z_what KL).
CONFIG5G_ARGV = ("--dataset", "cub_ckb_rot_6", "--z_bg_beta", "1", "--patch_size", "8",
                 "--latent_size", "64", "--bg_latent_size", "64", "--local_latent_size", "64",
                 "--model", "lg_glimpse_spair", "-split_z_l", "--z_what_beta", "0.5",
                 "-concat_z_what", "-dense_local", "-dense_bg", "--training_steps", "200000")
CONFIG5G = dict(CONFIG5, model="lg_glimpse_spair", training_steps=200_000)


def config5_glimpse(**overrides) -> SpairConfig:
    return SpairConfig(**{**CONFIG5G, **overrides})


# BASELINE config #2: LGVae (SPLIT-VAE) on CelebA 64x64 (bench.py:81-82). The
# image size is the dataset's, not a field of VaeConfig.
CONFIG2 = dict(model="lgvae", dataset="celeba64", no_label=True, beta=30.0, patch_size=8,
               batch_size=64)
CONFIG2_IMAGE_HW = (64, 64)


def config2(**overrides) -> VaeConfig:
    return VaeConfig(**{**CONFIG2, **overrides})


# BASELINE config #3: LGGMVae (SPLIT-GMVAE) on SVHN 32x32, labelled, with the
# reference flags of BASELINE.md ("--model lggmvae --beta 40 --alpha 40
# --y_size 30 --patch_size 4"); the batch is the CLI's default 64.
CONFIG3 = dict(model="lggmvae", dataset="svhn", beta=40.0, alpha=40.0, y_size=30, tau=0.4,
               patch_size=4, batch_size=64, global_latent_dims=128, local_latent_dims=128)
CONFIG3_IMAGE_HW = (32, 32)


def config3(**overrides) -> VaeConfig:
    return VaeConfig(**{**CONFIG3, **overrides})


# BASELINE config #4: LGGMVae (SPLIT-GMVAE) on CelebA 64x64, the README's
# command (``CONFIG4_ARGV``); the batch is the CLI's default 64. ``-viz`` only
# shapes the evals' figures, so ``config4`` leaves it at its default.
CONFIG4_ARGV = ("--model", "lggmvae", "--beta", "120", "--alpha", "40", "--y_size", "30",
                "--patch_size", "8", "--dataset", "celeba64", "-no_label", "-viz",
                "--training_steps", "3000000")
CONFIG4 = dict(model="lggmvae", dataset="celeba64", no_label=True, beta=120.0, alpha=40.0,
               y_size=30, tau=0.4, patch_size=8, batch_size=64, global_latent_dims=128,
               local_latent_dims=128, training_steps=3_000_000)
CONFIG4_IMAGE_HW = (64, 64)


def config4(**overrides) -> VaeConfig:
    return VaeConfig(**{**CONFIG4, **overrides})


def config_bg_spair(**overrides) -> SpairConfig:
    """BG-SPAIR at the defaults (32-px objects on 48-px canvases), batch 256."""
    return SpairConfig(**{**dict(model="bg_spair", batch_size=256), **overrides})


def config_glimpse_spair(**overrides) -> SpairConfig:
    """LGGlimpseSPAIR with 28-px objects (not a multiple of 8) in 4-px patches,
    the conv background path, batch 256."""
    return SpairConfig(**{**dict(model="lg_glimpse_spair", batch_size=256, object_size=28,
                                 patch_size=4), **overrides})
