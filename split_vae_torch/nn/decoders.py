"""VAE-family conv decoder (split_vae_tpu/nn/decoders.py): resize-then-conv upsampling.

Behavioural contract: vae/model.py:145-169. Upsampling is a bilinear resize
followed by a stride-1 conv, not a transposed conv. The last conv gives twice
the image's channels, split into (x_mean, x_log_scale) for the
discretized-logistic likelihood. Flax names kept: ``Dense_0``, ``Conv_0`` ..
``Conv_3``. As in the JAX package, only the output pair runs fused
(``Resize2xConvAny``, 6x6: no upsampled tensor is formed); ``Conv_1`` and
``Conv_2`` read ``resize_bilinear``'s output.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from split_vae_torch.nn.common import Conv, Dense, resize_bilinear
from split_vae_torch.nn.pixel_shuffle import Resize2xConvAny


class ConvDecoder(nn.Module):
    """Dense -> [conv -> resize] x 3 -> conv(2*C)."""

    def __init__(self, in_features: int, image_hw: Tuple[int, int], out_channels: int = 6,
                 device=None, dtype=None):
        super().__init__()
        self.image_hw = tuple(image_hw)
        self.out_channels = out_channels
        h, w = image_hw
        self.Dense_0 = Dense(in_features, h // 8 * (w // 8) * 128, device, dtype=dtype)
        self.Conv_0 = Conv(128, 128, (4, 4), device=device, dtype=dtype)
        self.Conv_1 = Conv(128, 64, (4, 4), device=device, dtype=dtype)
        self.Conv_2 = Conv(64, 32, (6, 6), device=device, dtype=dtype)
        self.Conv_3 = Resize2xConvAny(32, out_channels, (6, 6), (h, w), device, dtype=dtype)

    def forward(self, z: torch.Tensor):
        h, w = self.image_hw
        x = F.relu(self.Dense_0(z)).reshape(-1, h // 8, w // 8, 128)
        x = F.relu(self.Conv_0(x))
        x = resize_bilinear(x, h // 4, w // 4)
        x = F.relu(self.Conv_1(x))
        x = resize_bilinear(x, h // 2, w // 2)
        x = F.relu(self.Conv_2(x))
        x = self.Conv_3(x)
        half = self.out_channels // 2
        return x[..., :half], x[..., half:]
