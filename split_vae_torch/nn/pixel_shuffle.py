"""Resize2xConv (split_vae_tpu/nn/pixel_shuffle.py): bilinear 2x resize, then a SAME conv
(3x3 as the JAX ``Resize2xConv``, any size as its ``Resize2xConvAny``).

The JAX package folds the resize into the conv's phase kernels to keep the
upsampled tensor out of TPU memory; the two are the same map. The port
computes the chain as it reads: ``F.interpolate`` with half-pixel centers
(``align_corners=False``, equal to ``jax.image.resize(..., "bilinear")`` when
upsampling), then the conv. The parameters are the conv's (flax ``kernel``
and ``bias``). In bfloat16 (``dtype``) the input is cast first and the resize
runs in bfloat16, as in the JAX layers; the JAX fused forms then differ from
this chain by bfloat16 rounding, not by function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from split_vae_torch.nn.common import Conv


class Resize2xConv(Conv):
    def __init__(self, in_ch: int, out_ch: int, out_hw: Tuple[int, int], device=None,
                 kernel_size: Tuple[int, int] = (3, 3), dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, kernel_size, padding="SAME", device=device,
                         dtype=dtype)
        self.out_hw = tuple(out_hw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        up = F.interpolate(x.permute(0, 3, 1, 2), size=self.out_hw, mode="bilinear",
                           align_corners=False)
        return super().forward(up.permute(0, 2, 3, 1))
