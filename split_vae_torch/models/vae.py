"""SPLIT-VAE (split_vae_tpu/models/vae.py): LGVae and the VAE factory.

Behavioural contract: vae/model.py:174-218. Inputs are channel-stacked
[x | x_hat] views in [-1, 1]; the forward returns every latent and statistic
that the trainer reads. ``decode(rescale=True)`` maps the decoder's means from
[-1, 1] to clipped [0, 1] (vae/model.py:211-218).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from split_vae_torch.core.noise import Noise
from split_vae_torch.models.spair import require_device
from split_vae_torch.nn.common import init_params
from split_vae_torch.nn.decoders import ConvDecoder
from split_vae_torch.nn.encoders import ConvEncoder


class LGVaeOutput(NamedTuple):
    """Forward tuple of LGVae (vae/model.py:200), field for field."""

    x_mean: torch.Tensor
    x_log_scale: torch.Tensor
    z_x: torch.Tensor
    z_mean_x: torch.Tensor
    z_sig_x: torch.Tensor
    z_x_hat: torch.Tensor
    x_hat_mean: torch.Tensor
    x_hat_log_scale: torch.Tensor
    z_mean_x_hat: torch.Tensor
    z_sig_x_hat: torch.Tensor


def _rescale(x_mean: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x_mean + 1.0) * 0.5, 0.0, 1.0)


class LGVae(nn.Module):
    """SPLIT-VAE: independent global (x) and local (scrambled x_hat) paths.
    ``decoder_x`` reads concat([z_g, z_l]); ``decoder_x_hat`` reads z_l only.
    The input's channels are x (3) then the augmented view (3)."""

    def __init__(self, global_latent_dims: int, local_latent_dims: int,
                 image_hw: Tuple[int, int], device=None):
        super().__init__()
        self.encoder_x = ConvEncoder(image_hw, 3, global_latent_dims, device)
        self.encoder_x_hat = ConvEncoder(image_hw, 3, local_latent_dims, device)
        self.decoder_x = ConvDecoder(global_latent_dims + local_latent_dims, image_hw, 6, device)
        self.decoder_x_hat = ConvDecoder(local_latent_dims, image_hw, 6, device)

    def forward(self, inputs: torch.Tensor, training: bool, noise: Noise) -> LGVaeOutput:
        """``training`` changes nothing here (no dropout); the sampling stays
        on in eval, as in the reference's test steps."""
        x, x_hat = inputs[..., :3], inputs[..., 3:]
        z_x, z_mean_x, z_sig_x = self.encoder_x(x, noise)
        z_x_hat, z_mean_x_hat, z_sig_x_hat = self.encoder_x_hat(x_hat, noise)
        x_mean, x_log_scale = self.decoder_x(torch.cat([z_x, z_x_hat], dim=1))
        x_hat_mean, x_hat_log_scale = self.decoder_x_hat(z_x_hat)
        return LGVaeOutput(x_mean, x_log_scale, z_x, z_mean_x, z_sig_x, z_x_hat, x_hat_mean,
                           x_hat_log_scale, z_mean_x_hat, z_sig_x_hat)

    def encode(self, inputs: torch.Tensor, noise: Noise):
        x, x_hat = inputs[..., :3], inputs[..., 3:]
        return self.encoder_x(x, noise)[0], self.encoder_x_hat(x_hat, noise)[0]

    def decode(self, z_x: torch.Tensor, z_x_hat: torch.Tensor, rescale: bool = True):
        x_mean, _ = self.decoder_x(torch.cat([z_x, z_x_hat], dim=1))
        x_hat_mean, _ = self.decoder_x_hat(z_x_hat)
        if rescale:
            return _rescale(x_mean), _rescale(x_hat_mean)
        return x_mean, x_hat_mean


def get_vae_model(config, image_hw: Tuple[int, int], device="cuda",
                  generator: Optional[torch.Generator] = None) -> nn.Module:
    """Model factory on config.model (train/loop.py::build_vae_model). Only
    ``lgvae`` is ported; weights are glorot-uniform from ``generator`` (seeded
    with config.seed on the model's device if None)."""
    device = require_device(device)
    if config.model != "lgvae":
        raise NotImplementedError(f"Model type not ported yet: {config.model}")
    model = LGVae(config.global_latent_dims, config.local_latent_dims, tuple(image_hw),
                  device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(config.seed)
    init_params(model, generator)
    return model
