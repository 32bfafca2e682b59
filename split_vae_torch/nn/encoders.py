"""VAE-family encoders (split_vae_tpu/nn/encoders.py): the conv encoder.

Behavioural contract: vae/model.py:34-45,100-114. The sigma head gives a
standard deviation through softplus, not a log-variance. Submodules carry the
flax tree's names (``Conv_0`` .. ``Conv_2``, ``Dense_0``, ``Dense_1``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from split_vae_torch.core.noise import Noise
from split_vae_torch.nn.common import Conv, Dense, flatten
from split_vae_torch.ops.distributions import reparameterize


class ConvEncoder(nn.Module):
    """Three stride-2 SAME convs (32/64/128 filters, k = 6/6/4), then mean and
    softplus-sigma heads and one sample: (z, z_mean, z_sig)."""

    def __init__(self, image_hw: Tuple[int, int], in_channels: int, latent_dims: int = 32,
                 device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, 32, (6, 6), stride=2, device=device)
        self.Conv_1 = Conv(32, 64, (6, 6), stride=2, device=device)
        self.Conv_2 = Conv(64, 128, (4, 4), stride=2, device=device)
        h, w = image_hw
        for _ in range(3):
            h, w = -(-h // 2), -(-w // 2)  # SAME: ceil(n / stride)
        self.Dense_0 = Dense(h * w * 128, latent_dims, device)
        self.Dense_1 = Dense(h * w * 128, latent_dims, device)

    def forward(self, x: torch.Tensor, noise: Noise):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.relu(self.Conv_2(x))
        x = flatten(x)
        z_mean = self.Dense_0(x)
        z_sig = F.softplus(self.Dense_1(x))
        return reparameterize(z_mean, z_sig, noise.normal(z_sig.shape)), z_mean, z_sig
