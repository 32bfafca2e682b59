"""Layers with the JAX package's conventions (split_vae_tpu/nn/common.py).

- Tensors are NHWC at every public function; a convolution permutes to NCHW
  (a channels-last view, no copy) inside.
- Weights are glorot-uniform and biases zero, as Keras and the JAX package
  set them (a Dense built with ``bias_init=1.0`` starts at one, the JAX
  package's ``ones_bias``); ``init_params`` draws them from an explicit
  generator.
- ``Conv`` pads as TF/flax ``SAME`` does: total padding
  max((ceil(n/s) - 1)*s + k - n, 0), the odd pixel on the high side. Torch's
  symmetric ``padding=`` differs whenever that total is odd.
- The compute dtype of a Dense or Conv is given at construction: None (the
  default) computes in the parameters' dtype; ``torch.bfloat16`` (``--compute_dtype
  bfloat16``) casts the input, the weight and the bias to bfloat16 at each
  call and gives a bfloat16 output, as flax's ``dtype=`` does
  (``promote_dtype``): the product is rounded to bfloat16, then the bias
  added in bfloat16, as flax adds it. The parameters stay float32 either
  way, so their gradients and the optimizer's state do too.
- A Dense or Conv whose ``shard`` is set (``parallel/mesh.py::shard_state``)
  holds one block of its weight's output rows and computes its block of the
  output between the model group's collectives
  (``parallel/tensor.py``); the bias is added after the gather, in the
  compute dtype, as the bfloat16 form adds it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from split_vae_torch.parallel.tensor import copy_to_model, gather_features


def activation_dtype(name: str) -> Optional[torch.dtype]:
    """The compute dtype of ``config.compute_dtype``: None for float32 (no
    cast), ``torch.bfloat16`` for bfloat16."""
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype {name!r}: float32 or bfloat16")


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of TF/flax SAME for size n, kernel k, stride s."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Dense(nn.Module):
    """flax Dense: y = x @ W^T + b, W stored [out, in] (flax keeps [in, out])."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 bias_init: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.full((out_features,), bias_init, device=device))
        self.bias_init = bias_init
        self.dtype = dtype
        self.shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.shard is not None:
            x = copy_to_model(x, self.shard)
            y = F.linear(x if dt is None else x.to(dt),
                         self.weight if dt is None else self.weight.to(dt))
            return gather_features(y, self.shard) + (self.bias if dt is None else self.bias.to(dt))
        if dt is None:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class Conv(nn.Module):
    """flax Conv on NHWC tensors, weight OIHW (flax keeps HWIO)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: Tuple[int, int],
                 stride: int = 1, padding: str = "SAME", device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.shard is not None:
            x = copy_to_model(x, self.shard)
        xn = (x if dt is None else x.to(dt)).permute(0, 3, 1, 2)
        pad = 0
        if self.padding == "SAME":
            kh, kw = self.weight.shape[2:]
            (t, b), (l, r) = (same_pads(xn.shape[2], kh, self.stride),
                              same_pads(xn.shape[3], kw, self.stride))
            if (t, l) == (b, r):
                pad = (t, l)
            else:
                xn = F.pad(xn, (l, r, t, b))
        if self.shard is not None:
            y = F.conv2d(xn, self.weight if dt is None else self.weight.to(dt), None,
                         stride=self.stride, padding=pad)
            y = gather_features(y.permute(0, 2, 3, 1), self.shard)
            return y + (self.bias if dt is None else self.bias.to(dt))
        if dt is None:
            y = F.conv2d(xn, self.weight, self.bias, stride=self.stride, padding=pad)
            return y.permute(0, 2, 3, 1)
        y = F.conv2d(xn, self.weight.to(dt), None, stride=self.stride, padding=pad)
        return y.permute(0, 2, 3, 1) + self.bias.to(dt)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` on NHWC (or [B, F]) tensors, statistics over every
    axis but the last, at momentum 0.99 and eps 1e-3.

    ``weight`` and ``bias`` are flax's ``scale`` and ``bias``; the buffers
    ``running_mean`` and ``running_var`` its ``batch_stats`` mean and var. In
    training the batch variance is the biased one, E[x^2] - E[x]^2 clipped at
    0 (flax's fast variance), and the averages move as ra = momentum * ra +
    (1 - momentum) * batch. ``nn.BatchNorm2d`` updates ``running_var`` with
    the unbiased variance, so it does not stand in.
    """

    momentum, eps = 0.99, 1e-3  # the probe classifier's (vae/model.py:325-352)

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        x = x.to(self.weight.dtype)  # flax computes in the promoted dtype: bf16 inputs go up
        if training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp_min(torch.square(x).mean(dim=dims) - torch.square(mean), 0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout`` with its keep mask given: where(keep, x / (1 - rate), 0)."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def init_params(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Glorot-uniform weights for every Dense and Conv in module; Conv biases
    zero, Dense biases their ``bias_init``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Dense, Conv)):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                m.bias.fill_(getattr(m, "bias_init", 0.0))


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """tf.image.resize(method='bilinear') of NHWC (half-pixel centres) when upsampling."""
    up = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1)


def flatten(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [B, -1] in the tensor's logical (NHWC) order."""
    return x.reshape(x.shape[0], -1)
