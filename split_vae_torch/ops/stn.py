"""Spatial transformer (crop and paste) as separable products (split_vae_tpu/ops/stn.py).

The SPAIR affine is axis-aligned, so bilinear sampling factorizes into two
1-D interpolations: out[p, q] = sum_{i,j} Wy[p, i] * Wx[q, j] * img[i, j].
``Wy`` and ``Wx`` are banded interpolation matrices with the reference's
clipping semantics (spair/utils.py:229-246): samples outside the image net to
zero. Geometry stays f32. The crop hands its sample coordinates to
``kernels/crop.py``, which gathers the two taps of each row and column; the
paste keeps the dense matrices.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from split_vae_torch.kernels.crop import interp_matrix as _interp_matrix
from split_vae_torch.kernels.crop import stn_crop_taps

DEFAULT_CELL_RATIO = (2.0 * 12.0) / 48.0


@functools.lru_cache(maxsize=None)
def _cell_bias(grid_h: int, grid_w: int, cell_ratio: float) -> Tuple[tuple, tuple]:
    """Per-cell (tx, ty) center biases: i_p = (2-r)*i/(n-1) - (1 - r/2)."""

    def axis(n):
        if n == 1:
            return (0.0,)
        return tuple((2.0 - cell_ratio) * i / (n - 1) - (1.0 - 0.5 * cell_ratio)
                     for i in range(n))

    return axis(grid_w), axis(grid_h)


def zwhere_to_params(z_where: torch.Tensor, cell_ratio: float = DEFAULT_CELL_RATIO):
    """Raw z_where [B, gh, gw, 4] -> (sx, sy, tx, ty), each [B, gh*gw]."""
    z_where = z_where.float()
    b, gh, gw, _ = z_where.shape
    bias_tx_1d, bias_ty_1d = _cell_bias(gh, gw, cell_ratio)
    bias_tx = torch.tensor(bias_tx_1d, dtype=torch.float32, device=z_where.device)[None, :]
    bias_ty = torch.tensor(bias_ty_1d, dtype=torch.float32, device=z_where.device)[:, None]
    sx = 0.5 * torch.sigmoid(z_where[..., 0])
    sy = 0.5 * torch.sigmoid(z_where[..., 1])
    tx = 0.5 * torch.tanh(z_where[..., 2]) + bias_tx[None]
    ty = 0.5 * torch.tanh(z_where[..., 3]) + bias_ty[None]
    k = gh * gw
    return sx.reshape(b, k), sy.reshape(b, k), tx.reshape(b, k), ty.reshape(b, k)


def zwhere_to_bbox(sx, sy, tx, ty) -> torch.Tensor:
    """Normalized [ymin, xmin, ymax, xmax] corners, [B, K, 4]."""
    box_h = sy / 2.0
    box_w = sx / 2.0
    cy = (ty + 1.0) / 2.0
    cx = (tx + 1.0) / 2.0
    return torch.stack([cy - box_h / 2.0, cx - box_w / 2.0,
                        cy + box_h / 2.0, cx + box_w / 2.0], dim=-1)


def _sample_coords(scale, trans, out_size: int, in_size: int) -> torch.Tensor:
    """Per-(batch, cell) 1-D sample coordinates in input pixel space."""
    grid = torch.linspace(-1.0, 1.0, out_size, device=scale.device)
    pos = scale[..., None] * grid + trans[..., None]
    return 0.5 * (pos + 1.0) * (in_size - 1)


def crop_sample_coords(z_where: torch.Tensor, in_hw: Tuple[int, int],
                       out_hw: Tuple[int, int], cell_ratio: float = DEFAULT_CELL_RATIO):
    """Sample coordinates of the crop: (ys [B,K,ho], xs [B,K,wo], bbox [B,K,4])."""
    h_in, w_in = in_hw
    ho, wo = out_hw
    sx, sy, tx, ty = zwhere_to_params(z_where, cell_ratio)
    return (_sample_coords(sy, ty, ho, h_in), _sample_coords(sx, tx, wo, w_in),
            zwhere_to_bbox(sx, sy, tx, ty))


def crop_interp_weights(z_where: torch.Tensor, in_hw: Tuple[int, int],
                        out_hw: Tuple[int, int], cell_ratio: float = DEFAULT_CELL_RATIO):
    """Weights of the crop transform: (wy [B,K,ho,H], wx [B,K,wo,W], bbox [B,K,4])."""
    ys, xs, bbox = crop_sample_coords(z_where, in_hw, out_hw, cell_ratio)
    return _interp_matrix(ys, in_hw[0]), _interp_matrix(xs, in_hw[1]), bbox


def stn_crop(img: torch.Tensor, z_where: torch.Tensor, out_hw: Tuple[int, int],
             cell_ratio: float = DEFAULT_CELL_RATIO):
    """Crop per-cell glimpses: img [B,H,W,C], z_where [B,gh,gw,4] ->
    (glimpses [B,K,ho,wo,C], bbox [B,K,4]).

    The chain z_where -> ys, xs stays in autograd; the crop goes through
    ``kernels/crop.py::stn_crop_taps`` (the CUDA kernel pair on a GPU).
    """
    ys, xs, bbox = crop_sample_coords(z_where, img.shape[1:3], out_hw, cell_ratio)
    return stn_crop_taps(img, ys, xs), bbox


def paste_interp_weights(z_where: torch.Tensor, out_hw: Tuple[int, int],
                         in_hw: Tuple[int, int], cell_ratio: float = DEFAULT_CELL_RATIO,
                         eps: float = 1e-5):
    """Weights of the inverse (paste) transform: (wy [B,K,H,h], wx [B,K,W,w], bbox [B,K,4])."""
    wy, wx, bbox, _ = paste_interp_weights_ys(z_where, out_hw, in_hw, cell_ratio, eps)
    return wy, wx, bbox


def paste_interp_weights_ys(z_where: torch.Tensor, out_hw: Tuple[int, int],
                            in_hw: Tuple[int, int], cell_ratio: float = DEFAULT_CELL_RATIO,
                            eps: float = 1e-5):
    """paste_interp_weights and the row sample coordinates ys [B,K,H], which
    locate each cell's paste support (the windowed render needs them)."""
    h_in, w_in = in_hw
    ho, wo = out_hw
    sx, sy, tx, ty = zwhere_to_params(z_where, cell_ratio)
    bbox = zwhere_to_bbox(sx, sy, tx, ty)
    sx_i = 1.0 / (sx + eps)
    sy_i = 1.0 / (sy + eps)
    tx_i = -tx / (sx + eps)
    ty_i = -ty / (sy + eps)
    wx = _interp_matrix(_sample_coords(sx_i, tx_i, wo, w_in), w_in)
    ys = _sample_coords(sy_i, ty_i, ho, h_in)
    return _interp_matrix(ys, h_in), wx, bbox, ys


def stn_paste(objs: torch.Tensor, z_where: torch.Tensor, out_hw: Tuple[int, int],
              cell_ratio: float = DEFAULT_CELL_RATIO, eps: float = 1e-5):
    """Paste objects [B,K,h,w,C] onto canvases -> ([B,K,H,W,C], bbox [B,K,4])."""
    wy, wx, bbox = paste_interp_weights(z_where, out_hw, (objs.shape[2], objs.shape[3]),
                                        cell_ratio, eps)
    tmp = torch.einsum("bkpi,bkijc->bkpjc", wy, objs)
    out = torch.einsum("bkpjc,bkqj->bkpqc", tmp, wx)
    return out, bbox
