"""The SPAIR family and its factory (split_vae_tpu/models/spair.py): SPAIR,
BG-SPAIR, LG-SPAIR (SPLIT-SPAIR) and LGGlimpseSPAIR.

Behavioural contract: spair/spair.py:8-106 as the JAX package implements it
(``bg_spair`` is SPAIR with a background VAE; ``lg_glimpse_spair`` is the
JAX package's working assembly of a model the reference only names).
``fused_render=True`` sends the training forward through the fused
paste+composite render: the CUDA kernel pair for tensors on a GPU, its plain
version for tensors on the CPU. ``windowed=True`` at a model call takes the
row-windowed render pair instead of the full-canvas one (the JAX config has no
field for it, so it is chosen like ``fused``: by an argument of the call).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from split_vae_torch.core import tracing
from split_vae_torch.core.noise import Noise
from split_vae_torch.nn.common import activation_dtype, init_params
from split_vae_torch.nn.spair_nets import (
    BackgroundModel,
    GlimpseDecoder,
    ImageDecoder,
    ImageDecoderDense,
    ImageEncoder,
    ImageEncoderDense,
    SpairDecoder,
    SpairEncoder,
    fused_decode_render,
    render,
)


class SpairOutput(NamedTuple):
    """The JAX package's SpairOutput, field for field; absent fields are None."""

    x_recon: torch.Tensor
    z_what: torch.Tensor
    z_what_mean: torch.Tensor
    z_what_sigma: torch.Tensor
    z_where: torch.Tensor
    z_where_mean: torch.Tensor
    z_where_sigma: torch.Tensor
    z_depth: torch.Tensor
    z_depth_mean: torch.Tensor
    z_depth_sigma: torch.Tensor
    z_pres: torch.Tensor
    z_pres_logits: torch.Tensor
    z_pres_pre_sigmoid: torch.Tensor
    all_glimpses: torch.Tensor
    obj_recon_unnorm: torch.Tensor
    obj_recon_alpha: torch.Tensor
    obj_full_recon_unnorm: Optional[torch.Tensor]
    obj_bbox_mask: torch.Tensor
    z_bg: Optional[torch.Tensor] = None
    z_bg_mean: Optional[torch.Tensor] = None
    z_bg_sig: Optional[torch.Tensor] = None
    x_hat_recon: Optional[torch.Tensor] = None
    z_l: Optional[torch.Tensor] = None
    z_l_mean: Optional[torch.Tensor] = None
    z_l_sig: Optional[torch.Tensor] = None
    x_hat: Optional[torch.Tensor] = None


def _image_vae(dense: bool, image_hw, num_channel: int, latent_size: int, decoder_in: int,
               device, dtype=None):
    """An image encoder and decoder pair: the MLP one (``dense``) or the conv one."""
    h, w = image_hw
    if dense:
        return (ImageEncoderDense(h * w * num_channel, latent_size, device, dtype=dtype),
                ImageDecoderDense(decoder_in, image_hw, num_channel, device, dtype=dtype))
    return (ImageEncoder(image_hw, num_channel, latent_size, device, dtype=dtype),
            ImageDecoder(decoder_in, image_hw, num_channel, device, dtype=dtype))


class _SpairBase(nn.Module):
    """What the family shares: the decode + render tail of the forward.

    ``render_noise_scale`` is the fused render's noise (the JAX
    ``fused_decode_render(noise_scale=0.01)``); 0 turns it off, as the JAX
    package's interpret mode does. ``compute_dtype`` is every Dense and
    Conv's (None: float32); the train steps check it against the config's.
    """

    def __init__(self, image_hw: Tuple[int, int], num_channel: int, fused_render: bool,
                 render_noise_scale: float, dtype: Optional[torch.dtype]):
        super().__init__()
        self.compute_dtype = dtype
        self.image_hw = tuple(image_hw)
        self.num_channel = num_channel
        self.fused_render = fused_render
        self.render_noise_scale = render_noise_scale

    def decode_render(self, enc, bg_recon, training: bool, fused: Optional[bool], noise: Noise,
                      z_what_in: Optional[torch.Tensor] = None, windowed: bool = False,
                      **extra) -> SpairOutput:
        """The decoder and the render over the encoder's first 13 outputs ``enc``.

        ``z_what_in`` is what the decoder reads (and the output reports) where
        it differs from the encoder's z_what; ``extra`` fills the output's
        optional fields.
        """
        if fused is None:
            fused = self.fused_render
        c = self.num_channel
        (z_what, z_what_mean, z_what_sigma, z_where, z_where_mean, z_where_sigma,
         z_depth, z_depth_mean, z_depth_sigma, z_pres, z_pres_logits,
         z_pres_pre_sigmoid, all_glimpses) = enc
        if z_what_in is not None:
            z_what = z_what_in
        with tracing.span("forward.decode_render"):
            if training and fused:
                obj_recon_unnorm, obj_recon_alpha, obj_bbox, x_recon = fused_decode_render(
                    self.decoder, noise, z_what, z_where, z_depth, z_pres, bg_recon, c,
                    self.image_hw, self.render_noise_scale, windowed)
                obj_full = None
            else:
                obj_recon_unnorm, obj_recon_alpha, obj_full, obj_bbox = self.decoder(z_what,
                                                                                     z_where)
                eps = (noise.normal(obj_full.shape[:-1] + (c,), per_example=True) if training
                       else None)
                x_recon = render(obj_full, bg_recon, z_depth, z_pres, z_pres_logits, training,
                                 c, eps)
        return SpairOutput(
            x_recon, z_what, z_what_mean, z_what_sigma, z_where, z_where_mean,
            z_where_sigma, z_depth, z_depth_mean, z_depth_sigma, z_pres,
            z_pres_logits, z_pres_pre_sigmoid, all_glimpses, obj_recon_unnorm,
            obj_recon_alpha, obj_full, obj_bbox, **extra)


class SPAIR(_SpairBase):
    """SPAIR, and BG-SPAIR with ``bg`` (spair/spair.py:19-49). Without a
    background model the background is the scalar 0."""

    def __init__(self, image_hw: Tuple[int, int], object_size: int, latent_size: int,
                 tau: float, num_channel: int = 3, bg: bool = False, bg_latent_size: int = 4,
                 fused_render: bool = False, render_noise_scale: float = 0.01, device=None,
                 dtype=None):
        super().__init__(image_hw, num_channel, fused_render, render_noise_scale, dtype)
        self.bg = bg
        self.encoder = SpairEncoder(image_hw, num_channel, object_size, latent_size, tau,
                                    device=device, dtype=dtype)
        self.decoder = SpairDecoder(image_hw, object_size, num_channel, latent_size,
                                    latent_size, device, dtype=dtype)
        if bg:
            self.bg_model = BackgroundModel(image_hw, bg_latent_size, num_channel, device,
                                            dtype=dtype)

    def forward(self, inputs: torch.Tensor, training: bool, noise: Noise,
                fused: Optional[bool] = None, windowed: bool = False) -> SpairOutput:
        enc = self.encoder(inputs, noise)
        if not self.bg:
            return self.decode_render(enc, 0.0, training, fused, noise, windowed=windowed)
        bg_recon, z_bg, z_bg_mean, z_bg_sig = self.bg_model(inputs, noise)
        return self.decode_render(enc, bg_recon, training, fused, noise, windowed=windowed,
                                  z_bg=z_bg, z_bg_mean=z_bg_mean, z_bg_sig=z_bg_sig)


class LGSPAIR(_SpairBase):
    """SPLIT-SPAIR: SPAIR + a local (scrambled-view) path (spair/spair.py:52-106)."""

    def __init__(self, image_hw: Tuple[int, int], object_size: int, latent_size: int,
                 tau: float, num_channel: int = 3, bg_latent_size: int = 4,
                 local_latent_size: int = 64, dense_bg: bool = False,
                 dense_local: bool = False, concat_z_what: bool = False,
                 concat_backbone: bool = False, concat_z_bg: bool = False,
                 fused_render: bool = False, render_noise_scale: float = 0.01, device=None,
                 dtype=None):
        super().__init__(image_hw, num_channel, fused_render, render_noise_scale, dtype)
        self.concat_z_what = concat_z_what
        self.concat_backbone = concat_backbone
        self.concat_z_bg = concat_z_bg
        self.encoder = SpairEncoder(image_hw, num_channel, object_size, latent_size, tau,
                                    concat=concat_backbone,
                                    local_latent_size=local_latent_size, device=device,
                                    dtype=dtype)
        what = latent_size + (local_latent_size if concat_z_what else 0)
        self.decoder = SpairDecoder(image_hw, object_size, num_channel, what, latent_size,
                                    device, dtype=dtype)
        bg_in = bg_latent_size + (local_latent_size if concat_z_bg else 0)
        self.bg_encoder, self.bg_decoder = _image_vae(dense_bg, image_hw, num_channel,
                                                      bg_latent_size, bg_in, device, dtype)
        self.x_hat_encoder, self.x_hat_decoder = _image_vae(
            dense_local, image_hw, num_channel, local_latent_size, local_latent_size, device,
            dtype)

    def forward(self, inputs: torch.Tensor, training: bool, noise: Noise,
                fused: Optional[bool] = None, windowed: bool = False) -> SpairOutput:
        c = self.num_channel
        x, x_hat = inputs[..., :c], inputs[..., c:]

        z_l, z_l_mean, z_l_sig = self.x_hat_encoder(x_hat, noise)
        z_bg, z_bg_mean, z_bg_sig = self.bg_encoder(x, noise)
        enc = self.encoder(x, noise, z_l if self.concat_backbone else None)

        x_hat_recon = self.x_hat_decoder(z_l)
        z_bg_in = torch.cat([z_bg, z_l], dim=-1) if self.concat_z_bg else z_bg
        bg_recon = self.bg_decoder(z_bg_in)

        z_what = enc[0]
        if self.concat_z_what:
            b, gh, gw = z_what.shape[:3]
            tiled = z_l[:, None, None, :].expand(b, gh, gw, z_l.shape[-1])
            z_what = torch.cat([z_what, tiled], dim=-1)
        return self.decode_render(enc, bg_recon, training, fused, noise, z_what_in=z_what,
                                  windowed=windowed, z_bg=z_bg, z_bg_mean=z_bg_mean,
                                  z_bg_sig=z_bg_sig, x_hat_recon=x_hat_recon, z_l=z_l,
                                  z_l_mean=z_l_mean, z_l_sig=z_l_sig)


class LGGlimpseSPAIR(_SpairBase):
    """Glimpse-local SPLIT-SPAIR: SPAIR with a background VAE, per-cell local
    latents from patch-scrambled glimpses (``ObjEncoderScramble``) and a
    per-glimpse decoder that reconstructs the scrambled view. The span
    ``forward.glimpse_decode`` holds that decoder."""

    def __init__(self, image_hw: Tuple[int, int], object_size: int, latent_size: int,
                 tau: float, num_channel: int = 3, bg_latent_size: int = 4,
                 local_latent_size: int = 64, patch_size: int = 4, dense_bg: bool = False,
                 fused_render: bool = False, render_noise_scale: float = 0.01, device=None,
                 dtype=None):
        super().__init__(image_hw, num_channel, fused_render, render_noise_scale, dtype)
        self.object_size = object_size
        self.encoder = SpairEncoder(image_hw, num_channel, object_size, latent_size, tau,
                                    glimpse_local=True, patch_size=patch_size,
                                    local_latent_size=local_latent_size, device=device,
                                    dtype=dtype)
        self.decoder = SpairDecoder(image_hw, object_size, num_channel, latent_size,
                                    latent_size, device, dtype=dtype)
        self.bg_encoder, self.bg_decoder = _image_vae(dense_bg, image_hw, num_channel,
                                                      bg_latent_size, bg_latent_size, device, dtype)
        self.x_hat_decoder = GlimpseDecoder(object_size, num_channel, local_latent_size, device,
                                            dtype=dtype)

    def forward(self, inputs: torch.Tensor, training: bool, noise: Noise,
                fused: Optional[bool] = None, windowed: bool = False) -> SpairOutput:
        c, os_ = self.num_channel, self.object_size
        x = inputs[..., :c]
        z_bg, z_bg_mean, z_bg_sig = self.bg_encoder(x, noise)
        *enc, z_l, z_l_mean, z_l_sig, x_hat = self.encoder(x, noise)

        bg_recon = self.bg_decoder(z_bg)
        b, gh, gw, d = z_l.shape
        with tracing.span("forward.glimpse_decode"):
            x_hat_recon = self.x_hat_decoder(z_l.reshape(b * gh * gw, d))
        x_hat_recon = x_hat_recon.reshape(b, gh * gw, os_, os_, c)
        return self.decode_render(enc, bg_recon, training, fused, noise, windowed=windowed,
                                  z_bg=z_bg, z_bg_mean=z_bg_mean, z_bg_sig=z_bg_sig,
                                  x_hat_recon=x_hat_recon, z_l=z_l, z_l_mean=z_l_mean,
                                  z_l_sig=z_l_sig, x_hat=x_hat)


def require_device(device) -> torch.device:
    """The device asked for; raises for a CUDA device when CUDA is absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def get_spair_model(config, device="cuda",
                    generator: Optional[torch.Generator] = None) -> nn.Module:
    """Model factory on config.model (spair/spair.py:8-17).

    Weights are glorot-uniform from ``generator`` (a generator seeded with
    config.seed on the model's device if None); every Dense and Conv computes
    in config.compute_dtype.
    """
    device = require_device(device)
    common = dict(
        image_hw=(config.image_size[0], config.image_size[1]),
        object_size=config.object_size,
        latent_size=config.latent_size,
        tau=config.tau,
        num_channel=config.image_size[2],
        bg_latent_size=config.bg_latent_size,
        fused_render=config.fused_render,
        device=device,
        dtype=activation_dtype(config.compute_dtype),
    )
    if config.model == "lg_spair":
        model = LGSPAIR(
            local_latent_size=config.local_latent_size,
            dense_bg=config.dense_bg,
            dense_local=config.dense_local,
            concat_z_what=config.concat_z_what,
            concat_backbone=config.concat_backbone,
            concat_z_bg=config.concat_z_bg,
            **common)
    elif config.model == "lg_glimpse_spair":
        model = LGGlimpseSPAIR(
            local_latent_size=config.local_latent_size,
            patch_size=config.patch_size,
            dense_bg=config.dense_bg,
            **common)
    elif config.model in ("spair", "bg_spair"):
        model = SPAIR(bg=config.model == "bg_spair", **common)
    else:
        raise NotImplementedError(f"Model type not implemented: {config.model}")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(config.seed)
    init_params(model, generator)
    return model
