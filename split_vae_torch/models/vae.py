"""SPLIT-VAE model families (split_vae_tpu/models/vae.py): LGVae, LGGMVae, GMVae.

Behavioural contract: vae/model.py:174-320. Inputs are channel-stacked
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
from split_vae_torch.nn.common import activation_dtype, init_params
from split_vae_torch.nn.decoders import ConvDecoder
from split_vae_torch.nn.encoders import ConvEncoder, GMVaeEncoder


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


class LGGMVaeOutput(NamedTuple):
    """Forward tuple of LGGMVae (vae/model.py:248), field for field."""

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
    y: torch.Tensor
    y_logits: torch.Tensor
    z_prior_mean: torch.Tensor
    z_prior_sig: torch.Tensor


class GMVaeOutput(NamedTuple):
    """Forward tuple of GMVae (vae/model.py:297), field for field."""

    x_mean: torch.Tensor
    x_log_scale: torch.Tensor
    z_x: torch.Tensor
    z_mean_x: torch.Tensor
    z_sig_x: torch.Tensor
    y: torch.Tensor
    y_logits: torch.Tensor
    z_prior_mean: torch.Tensor
    z_prior_sig: torch.Tensor


def _rescale(x_mean: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x_mean + 1.0) * 0.5, 0.0, 1.0)


class LGVae(nn.Module):
    """SPLIT-VAE: independent global (x) and local (scrambled x_hat) paths.
    ``decoder_x`` reads concat([z_g, z_l]); ``decoder_x_hat`` reads z_l only.
    The input's channels are x (3) then the augmented view (3)."""

    def __init__(self, global_latent_dims: int, local_latent_dims: int,
                 image_hw: Tuple[int, int], device=None, dtype=None):
        super().__init__()
        self.global_latent_dims, self.local_latent_dims = global_latent_dims, local_latent_dims
        self.compute_dtype = dtype
        self.encoder_x = ConvEncoder(image_hw, 3, global_latent_dims, device, dtype=dtype)
        self.encoder_x_hat = ConvEncoder(image_hw, 3, local_latent_dims, device, dtype=dtype)
        self.decoder_x = ConvDecoder(global_latent_dims + local_latent_dims, image_hw, 6, device,
                                     dtype=dtype)
        self.decoder_x_hat = ConvDecoder(local_latent_dims, image_hw, 6, device, dtype=dtype)

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


class LGGMVae(nn.Module):
    """SPLIT-GMVAE: LGVae with a Gaussian-mixture global encoder
    (vae/model.py:221-275).

    Draw order of a forward, in the port's one stream: the global encoder's
    Gumbel uniforms, its z normals, the local encoder's z normals, then, when
    training, the two dropout keep masks (``y_drop``, ``do5``). The first
    three are the JAX package's 'sample' stream in its order; the masks are
    its separate 'dropout' stream, put last here."""

    def __init__(self, global_latent_dims: int, local_latent_dims: int,
                 image_hw: Tuple[int, int], y_size: int, tau: float, device=None, dtype=None):
        super().__init__()
        self.global_latent_dims, self.local_latent_dims = global_latent_dims, local_latent_dims
        self.y_size, self.compute_dtype = y_size, dtype
        self.encoder_x = GMVaeEncoder(image_hw, 3, global_latent_dims, y_size, tau, device,
                                      dtype=dtype)
        self.encoder_x_hat = ConvEncoder(image_hw, 3, local_latent_dims, device, dtype=dtype)
        self.decoder_x = ConvDecoder(global_latent_dims + local_latent_dims, image_hw, 6, device,
                                     dtype=dtype)
        self.decoder_x_hat = ConvDecoder(local_latent_dims, image_hw, 6, device, dtype=dtype)

    def forward(self, inputs: torch.Tensor, training: bool, noise: Noise) -> LGGMVaeOutput:
        x, x_hat = inputs[..., :3], inputs[..., 3:]
        b = inputs.shape[0]
        u, eps = self.encoder_x.sample_draws(noise, b)
        z_x_hat, z_mean_x_hat, z_sig_x_hat = self.encoder_x_hat(x_hat, noise)
        keeps = self.encoder_x.keep_draws(noise, b) if training else None
        z_x, z_mean_x, z_sig_x, y, y_logits, z_prior_mean, z_prior_sig = \
            self.encoder_x.apply_draws(x, u, eps, keeps)
        x_mean, x_log_scale = self.decoder_x(torch.cat([z_x, z_x_hat], dim=1))
        x_hat_mean, x_hat_log_scale = self.decoder_x_hat(z_x_hat)
        return LGGMVaeOutput(x_mean, x_log_scale, z_x, z_mean_x, z_sig_x, z_x_hat, x_hat_mean,
                             x_hat_log_scale, z_mean_x_hat, z_sig_x_hat, y, y_logits,
                             z_prior_mean, z_prior_sig)

    def encode(self, inputs: torch.Tensor, noise: Noise):
        x, x_hat = inputs[..., :3], inputs[..., 3:]
        return self.encoder_x(x, False, noise)[0], self.encoder_x_hat(x_hat, noise)[0]

    def decode(self, z_x: torch.Tensor, z_x_hat: torch.Tensor, rescale: bool = True):
        x_mean, _ = self.decoder_x(torch.cat([z_x, z_x_hat], dim=1))
        x_hat_mean, _ = self.decoder_x_hat(z_x_hat)
        if rescale:
            return _rescale(x_mean), _rescale(x_hat_mean)
        return x_mean, x_hat_mean

    def encode_y(self, y: torch.Tensor):
        return self.encoder_x.encode_y(y)

    def get_y(self, x: torch.Tensor, noise: Noise):
        out = self.encoder_x(x[..., :3], False, noise)
        return out[3], out[4]


class GMVae(nn.Module):
    """GMVAE baseline: one GM encoder and a decoder, no local path
    (vae/model.py:277-320). It reads the first 3 channels of the input.
    Draw order: the Gumbel uniforms, the z normals, then, when training, the
    two keep masks."""

    def __init__(self, global_latent_dims: int, image_hw: Tuple[int, int], y_size: int,
                 tau: float, device=None, dtype=None):
        super().__init__()
        self.global_latent_dims, self.y_size = global_latent_dims, y_size
        self.compute_dtype = dtype
        self.encoder_x = GMVaeEncoder(image_hw, 3, global_latent_dims, y_size, tau, device,
                                      dtype=dtype)
        self.decoder_x = ConvDecoder(global_latent_dims, image_hw, 6, device, dtype=dtype)

    def forward(self, inputs: torch.Tensor, training: bool, noise: Noise) -> GMVaeOutput:
        z_x, z_mean_x, z_sig_x, y, y_logits, z_prior_mean, z_prior_sig = self.encoder_x(
            inputs[..., :3], training, noise)
        x_mean, x_log_scale = self.decoder_x(z_x)
        return GMVaeOutput(x_mean, x_log_scale, z_x, z_mean_x, z_sig_x, y, y_logits,
                           z_prior_mean, z_prior_sig)

    def encode(self, inputs: torch.Tensor, noise: Noise) -> torch.Tensor:
        return self.encoder_x(inputs[..., :3], False, noise)[0]

    def decode(self, z_x: torch.Tensor, rescale: bool = True):
        x_mean, _ = self.decoder_x(z_x)
        return _rescale(x_mean) if rescale else x_mean

    def encode_y(self, y: torch.Tensor):
        return self.encoder_x.encode_y(y)

    def get_y(self, x: torch.Tensor, noise: Noise):
        out = self.encoder_x(x[..., :3], False, noise)
        return out[3], out[4]


def get_vae_model(config, image_hw: Tuple[int, int], device="cuda",
                  generator: Optional[torch.Generator] = None) -> nn.Module:
    """Model factory on config.model (train/loop.py::build_vae_model): lgvae,
    lggmvae or gmvae; weights are glorot-uniform from ``generator`` (seeded
    with config.seed on the model's device if None); every Dense and Conv
    computes in config.compute_dtype."""
    device = require_device(device)
    hw = tuple(image_hw)
    dtype = activation_dtype(config.compute_dtype)
    if config.model == "lgvae":
        model = LGVae(config.global_latent_dims, config.local_latent_dims, hw, device=device,
                      dtype=dtype)
    elif config.model == "lggmvae":
        model = LGGMVae(config.global_latent_dims, config.local_latent_dims, hw, config.y_size,
                        config.tau, device=device, dtype=dtype)
    elif config.model == "gmvae":
        model = GMVae(config.global_latent_dims, hw, config.y_size, config.tau, device=device,
                      dtype=dtype)
    else:
        raise NotImplementedError(config.model)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(config.seed)
    init_params(model, generator)
    return model
