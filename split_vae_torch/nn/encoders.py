"""VAE-family encoders (split_vae_tpu/nn/encoders.py): conv, fully connected, GM.

Behavioural contract: vae/model.py:16-141. Sigma heads give a standard
deviation through softplus, not a log-variance. Submodules carry the flax
tree's names, so the parameter converter maps them by path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from split_vae_torch.core.noise import Noise
from split_vae_torch.nn.common import Conv, Dense, dropout, flatten
from split_vae_torch.ops.distributions import gumbel_softmax, reparameterize


def _flat_size(image_hw: Tuple[int, int], channels: int) -> int:
    """Features after three stride-2 SAME convs (ceil(n / 2) each) of ``channels``."""
    h, w = image_hw
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
    return h * w * channels


class ConvEncoder(nn.Module):
    """Three stride-2 SAME convs (32/64/128 filters, k = 6/6/4), then mean and
    softplus-sigma heads and one sample: (z, z_mean, z_sig)."""

    def __init__(self, image_hw: Tuple[int, int], in_channels: int, latent_dims: int = 32,
                 device=None, dtype=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, 32, (6, 6), stride=2, device=device, dtype=dtype)
        self.Conv_1 = Conv(32, 64, (6, 6), stride=2, device=device, dtype=dtype)
        self.Conv_2 = Conv(64, 128, (4, 4), stride=2, device=device, dtype=dtype)
        flat = _flat_size(image_hw, 128)
        self.Dense_0 = Dense(flat, latent_dims, device, dtype=dtype)
        self.Dense_1 = Dense(flat, latent_dims, device, dtype=dtype)

    def forward(self, x: torch.Tensor, noise: Noise):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.relu(self.Conv_2(x))
        x = flatten(x)
        z_mean = self.Dense_0(x)
        z_sig = F.softplus(self.Dense_1(x))
        z = reparameterize(z_mean, z_sig, noise.normal_like(z_sig, per_example=True))
        return z, z_mean, z_sig


class FCEncoder(nn.Module):
    """Fully connected encoder: flatten -> Dense 1024 -> Dense 512 (relu) ->
    heads (vae/model.py:23-32,85-98; unreachable from the reference CLI).

    Reference quirk kept: in the variational form the second head has no
    activation and is taken as the sigma all the same (vae/model.py:93-94).
    The non-variational form returns relu(Dense) alone.
    """

    def __init__(self, in_features: int, latent_dims: int = 32, variational: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.variational = variational
        self.Dense_0 = Dense(in_features, 1024, device, dtype=dtype)
        self.Dense_1 = Dense(1024, 512, device, dtype=dtype)
        self.Dense_2 = Dense(512, latent_dims, device, dtype=dtype)
        if variational:
            self.Dense_3 = Dense(512, latent_dims, device, dtype=dtype)

    def forward(self, x: torch.Tensor, noise: Optional[Noise] = None):
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(flatten(x)))))
        if not self.variational:
            return F.relu(self.Dense_2(x))
        z_mean = self.Dense_2(x)
        z_sig = self.Dense_3(x)  # the raw head taken as sigma (quirk)
        z = reparameterize(z_mean, z_sig, noise.normal_like(z_sig, per_example=True))
        return z, z_mean, z_sig


GM_DROPOUT = 0.2


class GMVaeEncoder(nn.Module):
    """Gaussian-mixture encoder with a Gumbel-softmax cluster posterior
    (vae/model.py:48-79,116-140).

    elu conv block (128 filters, k = 6/6/4, stride 2) -> y block (Dense 1024,
    dropout 0.2, Dense 128) -> y logits -> Gumbel-softmax(tau) -> the
    y-conditional z prior (``encode_y``; softplus sigma, bias 1 at init) and
    the encoder head h = elu(e1(dropout(h))) + elu(h_top_dense(y)) -> z mean,
    softplus sigma (bias 1 at init), one sample. Only the two dropouts that
    the reference applies are here (it builds five more and never calls
    them, vae/model.py:59-76). Returns (z, z_mean, z_sig, y, y_logits,
    z_prior_mean, z_prior_sig).

    Draws: ``sample_draws`` gives the Gumbel uniforms [B, y_size], then the
    z normals [B, latent_dims]; ``keep_draws`` the keep masks of ``y_drop``
    [B, 1024], then of ``do5`` [B, flat], taken only when training. A model
    draws them and calls ``apply_draws``, so it can put other draws between
    them; ``forward`` draws the four in that order itself.
    """

    def __init__(self, image_hw: Tuple[int, int], in_channels: int, latent_dims: int,
                 y_size: int, tau: float, device=None, dtype=None):
        super().__init__()
        self.latent_dims, self.y_size, self.tau = latent_dims, y_size, tau
        self.flat = _flat_size(image_hw, 128)
        self.h_conv1 = Conv(in_channels, 128, (6, 6), stride=2, device=device, dtype=dtype)
        self.h_conv2 = Conv(128, 128, (6, 6), stride=2, device=device, dtype=dtype)
        self.h_conv3 = Conv(128, 128, (4, 4), stride=2, device=device, dtype=dtype)
        self.y_dense1 = Dense(self.flat, 1024, device, dtype=dtype)
        self.y_dense2 = Dense(1024, 128, device, dtype=dtype)
        self.y_head = Dense(128, y_size, device, dtype=dtype)
        self.h_top_dense = Dense(y_size, 512, device, dtype=dtype)
        self.z_prior_mean_head = Dense(y_size, latent_dims, device, dtype=dtype)
        self.z_prior_sig_head = Dense(y_size, latent_dims, device, bias_init=1.0,
                                      dtype=dtype)
        self.e1 = Dense(self.flat, 512, device, dtype=dtype)
        self.z_mean_head = Dense(512, latent_dims, device, dtype=dtype)
        self.z_sig_head = Dense(512, latent_dims, device, bias_init=1.0, dtype=dtype)

    def sample_draws(self, noise: Noise, batch: int):
        """In the compute dtype, as the logits and sigmas they perturb."""
        dt = self.z_sig_head.dtype
        return (noise.uniform((batch, self.y_size), dt, per_example=True),
                noise.normal((batch, self.latent_dims), dt, per_example=True))

    def keep_draws(self, noise: Noise, batch: int):
        return (noise.keep((batch, 1024), GM_DROPOUT, per_example=True),
                noise.keep((batch, self.flat), GM_DROPOUT, per_example=True))

    def forward(self, x: torch.Tensor, training: bool, noise: Noise):
        u, eps = self.sample_draws(noise, x.shape[0])
        keeps = self.keep_draws(noise, x.shape[0]) if training else None
        return self.apply_draws(x, u, eps, keeps)

    def apply_draws(self, x: torch.Tensor, u: torch.Tensor, eps: torch.Tensor,
                    keeps: Optional[Tuple[torch.Tensor, torch.Tensor]]):
        """The forward on given draws; ``keeps`` None is flax's deterministic dropout."""
        h = F.elu(self.h_conv1(x))
        h = F.elu(self.h_conv2(h))
        h = flatten(F.elu(self.h_conv3(h)))

        y_hidden = F.elu(self.y_dense1(h))
        if keeps is not None:
            y_hidden = dropout(y_hidden, keeps[0], GM_DROPOUT)
        y_hidden = F.elu(self.y_dense2(y_hidden))
        y_logits = self.y_head(y_hidden)
        y = gumbel_softmax(y_logits, self.tau, u=u)

        z_prior_mean, z_prior_sig = self.encode_y(y)

        h_top = F.elu(self.h_top_dense(y))
        if keeps is not None:
            h = dropout(h, keeps[1], GM_DROPOUT)
        h = F.elu(self.e1(h)) + h_top
        z_mean = self.z_mean_head(h)
        z_sig = F.softplus(self.z_sig_head(h))
        z = reparameterize(z_mean, z_sig, eps)
        return z, z_mean, z_sig, y, y_logits, z_prior_mean, z_prior_sig

    def encode_y(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """y -> (z prior mean, z prior sigma) (vae/model.py:137-140)."""
        return self.z_prior_mean_head(y), F.softplus(self.z_prior_sig_head(y))
