"""Exact fusion of (half-pixel bilinear 2x resize -> SAME conv)
(split_vae_tpu/nn/pixel_shuffle.py).

The decoders upsample a feature map 2x and convolve it at once: every
``Resize2xConv`` of ``nn/spair_nets.py`` (``ImageDecoder``,
``BackgroundModel``, ``GlimpseDecoder``, ``ObjDecoder``) and ``ConvDecoder``'s
output layer (``Resize2xConvAny``, 6x6). These forms compute
conv(resize2x(x)) without forming resize2x(x), exactly:

- Half-pixel 2x bilinear is a 2-phase 3-tap stencil on the source grid,
  U[2i] = 0.25 x[i-1] + 0.75 x[i] and U[2i+1] = 0.75 x[i] + 0.25 x[i+1], with
  edge clamp: the same stencil on an edge-padded x.
- ``resize2x_conv`` (3x3, the phase form): the stencil folded into the conv
  gives four 3x3 kernels on the source grid (W[py, px] = A_py^T K A_px per
  axis), one conv with 4 Cout channels on the edge-padded source and a
  depth-to-space (``F.pixel_shuffle``). The conv on the upsampled grid
  zero-pads outside it, where the fused one reads clamp-extended values;
  ``_ring_correction`` subtracts the difference, the four phantom lines' 1-D
  convs (each folded with its stencil into one product), on the output's
  outermost ring.
- ``resize2x_conv_any`` (any k, the dilated form): the stencil folded into a
  (k+3)x(k+3) kernel and one stride-2 transposed conv on the edge-padded
  source (JAX's ``lhs_dilation=2`` conv); the border rows and columns where
  the reference's zero padding meets the image are computed as the reference
  does on thin upsampled strips (one conv for two opposite sides), and the
  result assembled by concatenation.
- The mixed forms: the fused forward with the materialized chain's backward
  (``_materialized_bwd``), no forward conv wasted.

Beyond the JAX forms, which read one side ``s`` for both axes, these take
h != w. Tensors are NHWC and weights OIHW (``nn/common.py::Conv``) at the
public functions; the work is NCHW inside. In bfloat16 the phase and folded
kernels are formed in bfloat16, the JAX einsums' products bit for bit. Both
forms' backwards are written out (``_PhaseForm``, ``_DilatedForm``): the
convs' own backward and a few products, with no autograd node for each of
the forward's small operations, no atomic adds (``replicate``'s backward
scatters every element) and no copy of the whole gradient for each in-place
write to a slice. The layers fall back to ``resize2x_conv_chain``
(``F.interpolate``, then the conv) only where their output is not exactly
twice their input, the JAX layers' rule.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from split_vae_torch.nn.common import Conv, same_pads
from split_vae_torch.parallel.tensor import copy_to_model, gather_features

# A_p[t, d]: the weight of source tap x[i+d-1] in U[2i+p+t-1] (t: the conv's
# taps on the upsampled grid, d: taps on the source grid).
_A0 = np.array([[0.75, 0.25, 0.0],
                [0.25, 0.75, 0.0],
                [0.0, 0.75, 0.25]], np.float32)
_A1 = np.array([[0.25, 0.75, 0.0],
                [0.0, 0.75, 0.25],
                [0.0, 0.25, 0.75]], np.float32)


def _stencil_matrix(k: int) -> np.ndarray:
    """S[t, j] with W[j] = sum_t S[t, j] K[t]: folds the 4-tap half-pixel
    stencil [0.25, 0.75, 0.75, 0.25] (the weight of x[m] in U[2m+d], d = -1..2)
    into a conv kernel read over the 2x-dilated source."""
    s_tap = {-1: 0.25, 0: 0.75, 1: 0.75, 2: 0.25}
    mat = np.zeros((k, k + 3), np.float32)
    for t in range(k):
        for j in range(k + 3):
            mat[t, j] = s_tap.get(2 + t - j, 0.0)
    return mat


def _upsample_matrix(n: int) -> np.ndarray:
    """M [2n, n] with U = M x: the half-pixel 2x stencil with edge clamp."""
    mat = np.zeros((2 * n, n), np.float32)
    for i in range(n):
        mat[2 * i, max(i - 1, 0)] += 0.25
        mat[2 * i, i] += 0.75
        mat[2 * i + 1, i] += 0.75
        mat[2 * i + 1, min(i + 1, n - 1)] += 0.25
    return mat


def _phase_stencils() -> np.ndarray:
    return np.stack([_A0, _A1])


def _flipped_stencil(k: int) -> np.ndarray:
    """``_stencil_matrix(k)`` with its columns reversed: a transposed conv
    reads the dilated conv's kernel flipped."""
    return _stencil_matrix(k)[:, ::-1].copy()


def _padded_upsample(n: int, k: int) -> np.ndarray:
    """``_upsample_matrix(n)`` between the SAME padding's zero rows of a k-tap
    conv: [(k - 1) // 2 + 2n + k // 2, n]."""
    return np.concatenate([np.zeros(((k - 1) // 2, n), np.float32), _upsample_matrix(n),
                           np.zeros((k // 2, n), np.float32)])


def _strips(n: int, k: int) -> np.ndarray:
    """[2, 1, 1, 2k - 2, n]: the first and the last k - 1 rows of
    ``_upsample_matrix(n)``, each between the SAME padding's zero rows of a
    k-tap conv. A valid conv over the first gives the (k - 1) // 2 outputs at
    the start of the axis, over the second the k // 2 at its end, each last
    in its k - 1 outputs."""
    m = _upsample_matrix(n)
    lo, hi = np.zeros(((k - 1) // 2, n), np.float32), np.zeros((k // 2, n), np.float32)
    pair = np.stack([np.concatenate([lo, m[:k - 1], hi]), np.concatenate([lo, m[-(k - 1):], hi])])
    return pair[:, None, None]


def _line_taps(n: int, clamp: bool) -> np.ndarray:
    """T [3, 2n, n], T[t, c] = E[c + t]: the 3 taps at output c of the phantom
    line E x, E = ``_upsample_matrix(n)`` extended by one row at each end
    (the clamp's end values, or zeros)."""
    m = _upsample_matrix(n)
    ends = (m[:1], m[-1:]) if clamp else (np.zeros((1, n), np.float32),) * 2
    ext = np.concatenate([ends[0], m, ends[1]])
    return np.stack([ext[t:t + 2 * n] for t in range(3)])


def _ring_taps(h: int, w: int) -> np.ndarray:
    """[4, 3, 2L, L], L = max(h, w): ``_line_taps`` of the phantom rows -1
    and 2h (length w, clamped ends), then of the columns -1 and 2w (length h,
    zero ends), zero past each line's length."""
    size = max(h, w)
    taps = np.zeros((4, 3, 2 * size, size), np.float32)
    taps[:2, :, :2 * w, :w] = _line_taps(w, True)
    taps[2:, :, :2 * h, :h] = _line_taps(h, False)
    return taps


@functools.lru_cache(maxsize=None)
def _constant(make, args: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``make(*args)`` as a tensor on ``device``, made once for each
    (args, dtype, device): a copy from the host on every call would wait for
    the stream."""
    return torch.as_tensor(make(*args), dtype=dtype, device=device)


def _conv(x: torch.Tensor, weight: torch.Tensor, padding: str) -> torch.Tensor:
    """Stride-1 conv of NCHW x, flax's ``SAME`` (the odd pixel on the high
    side) or ``VALID``."""
    if padding == "VALID":
        return F.conv2d(x, weight)
    kh, kw = weight.shape[2:]
    (t, b), (l, r) = same_pads(x.shape[2], kh, 1), same_pads(x.shape[3], kw, 1)
    if (t, l) == (b, r):
        return F.conv2d(x, weight, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), weight)


def _phase_kernels(weight: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3] -> the per-phase kernels [4 Cout, Cin, 3, 3].

    Output channels are ordered (cout, py, px), the order ``F.pixel_shuffle``
    reads (the JAX form orders the blocks (py, px, cout) for its reshape).
    The rows' taps are contracted first, then the columns', as the JAX einsum
    does: in bfloat16 the two roundings then fall alike."""
    cout, cin = weight.shape[:2]
    a = _constant(_phase_stencils, (), weight.dtype, weight.device)
    rows = torch.einsum("oiyx,pyd->oipdx", weight, a)
    return torch.einsum("oipdx,qxe->opqide", rows, a).reshape(4 * cout, cin, 3, 3)


def _upsample1d_row(row: torch.Tensor) -> torch.Tensor:
    """[..., s] -> [..., 2s]: the exact half-pixel stencil with edge clamp, as
    one product with its matrix."""
    m = _constant(_upsample_matrix, (row.shape[-1],), row.dtype, row.device)
    return torch.matmul(row, m.mT)


def _upsample2x_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact half-pixel 2x bilinear (edge clamp) along one dim."""
    return _upsample1d_row(x.movedim(dim, -1)).movedim(-1, dim)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Half-pixel bilinear 2x of NCHW x in both spatial dims (equal to
    ``jax.image.resize(..., "bilinear")`` when upsampling)."""
    return F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]), mode="bilinear",
                         align_corners=False)


def _edge_pad_backward(g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``F.pad(x, (1, 1, 1, 1), mode="replicate")`` from the
    padded tensor's: two copies and four line sums (``replicate``'s own
    backward adds every element atomically)."""
    rows = g[:, :, 1:-1].clone()
    rows[:, :, 0].add_(g[:, :, 0])
    rows[:, :, -1].add_(g[:, :, -1])
    dx = rows[..., 1:-1].clone()
    dx[..., 0].add_(rows[..., 0])
    dx[..., -1].add_(rows[..., -1])
    return dx


def _border_lines(t: torch.Tensor) -> torch.Tensor:
    """The first and last rows, then the first and last columns, of NCHW t,
    each zero-padded to L = max(h, w): [4, N, C * L]."""
    n, _, h, w = t.shape
    size = max(h, w)
    lines = []
    for dim, length in ((2, h), (3, w)):
        ends = slice(None, None, length - 1) if length > 1 else [0, 0]
        pair = t[(slice(None),) * dim + (ends,)].movedim(dim, 0)
        lines.append(F.pad(pair, (0, size - pair.shape[-1])) if pair.shape[-1] < size else pair)
    return torch.cat(lines).reshape(4, n, -1)


def _add_border_lines(t: torch.Tensor, lines: torch.Tensor) -> None:
    """t's border += lines [4, N, C * L], the transpose of ``_border_lines``."""
    n, c, h, w = t.shape
    lines = lines.view(4, n, c, -1)
    t[:, :, 0].add_(lines[0, ..., :w])
    t[:, :, -1].add_(lines[1, ..., :w])
    t[..., 0].add_(lines[2, ..., :h])
    t[..., -1].add_(lines[3, ..., :h])


def _ring_fold(weight: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[4, Cin * L, Cout * 2L]: for each phantom line, its stencil folded with
    the kernel's slice that reads it (rows 0 and 2, then columns 0 and 2)."""
    cout, cin = weight.shape[:2]
    size = max(h, w)
    slices = torch.cat([weight[:, :, ::2], weight[..., ::2].mT], 2)  # [Cout, Cin, 4, 3]
    taps = _constant(_ring_taps, (h, w), weight.dtype, weight.device)
    return torch.einsum("oilt,ltcj->lijoc", slices, taps).reshape(4, cin * size, cout * 2 * size)


def _ring_correction(x: torch.Tensor, weight: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Subtract the clamp-vs-zero-pad difference on the outermost ring of out,
    in place, in the JAX form's order (top, bottom, left, right).

    The fused conv read clamp-extended U at the four phantom lines (row -1,
    row 2h, col -1, col 2w) where the reference conv reads zeros. The rows own
    every dy = +-1 tap, the corners included (their phantom lines clamp-padded
    at the ends); the columns own the dx = +-1 taps off the phantom rows
    (zero-padded ends). A line's term is linear in its source line, so the
    stencil and the kernel's slice fold into one matrix a line, and the four
    lines are one batched product. x [N, Cin, h, w], out [N, Cout, 2h, 2w]."""
    n, _, h, w = x.shape
    terms = torch.bmm(_border_lines(x), _ring_fold(weight, h, w)).view(4, n, weight.shape[0], -1)
    out[:, :, 0].sub_(terms[0, ..., :2 * w])
    out[:, :, -1].sub_(terms[1, ..., :2 * w])
    out[..., 0].sub_(terms[2, ..., :2 * h])
    out[..., -1].sub_(terms[3, ..., :2 * h])
    return out


class _PhaseForm(torch.autograd.Function):
    """The phase form on NCHW x, its backward written out: the transposes of
    the conv, the depth-to-space, the edge pad, the ring and the phase
    kernels."""

    @staticmethod
    def forward(ctx, x, weight):
        xe = F.pad(x, (1, 1, 1, 1), mode="replicate")
        phase = _phase_kernels(weight)
        out = F.pixel_shuffle(F.conv2d(xe, phase), 2)
        ctx.save_for_backward(xe, weight, phase)
        return _ring_correction(x, weight, out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xe, weight, phase = ctx.saved_tensors
        x = xe[:, :, 1:-1, 1:-1]
        h, w = x.shape[2:]
        g_xe, g_phase, _ = torch.ops.aten.convolution_backward(
            F.pixel_unshuffle(g, 2), xe, phase, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
            [True, True, False])
        g_terms = _border_lines(g).neg_()
        fold = _ring_fold(weight, h, w)
        gx = _edge_pad_backward(g_xe)
        _add_border_lines(gx, torch.bmm(g_terms, fold.mT))
        a = _constant(_phase_stencils, (), weight.dtype, weight.device)
        g_phase = torch.einsum("opqide,qxe->opidx", g_phase.view(-1, 2, 2, *phase.shape[1:]), a)
        gw = torch.einsum("opidx,pyd->oiyx", g_phase, a)
        g_fold = torch.bmm(_border_lines(x).mT, g_terms).view(4, -1, max(h, w), gw.shape[0],
                                                                  2 * max(h, w))
        g_slices = torch.einsum("lijoc,ltcj->oilt", g_fold,
                                _constant(_ring_taps, (h, w), weight.dtype, weight.device))
        gw[:, :, 0].add_(g_slices[:, :, 0])
        gw[:, :, 2].add_(g_slices[:, :, 1])
        gw[..., 0].add_(g_slices[:, :, 2])
        gw[..., 2].add_(g_slices[:, :, 3])
        return gx, gw


def _folded_kernel(weight: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, kh, kw] -> the stencil folded into a (kh+3)x(kw+3) kernel,
    flipped and [Cin, Cout] first for ``F.conv_transpose2d``. The rows' taps
    are contracted first, then the columns', as the JAX einsum does."""
    kh, kw = weight.shape[2:]
    dt, dev = weight.dtype, weight.device
    rows = torch.einsum("oiyx,yd->oidx", weight, _constant(_flipped_stencil, (kh,), dt, dev))
    return torch.einsum("oidx,xe->iode", rows, _constant(_flipped_stencil, (kw,), dt, dev))


class _DilatedForm(torch.autograd.Function):
    """The dilated form on NCHW x (see ``resize2x_conv_any``), its backward
    written out as ``_PhaseForm``'s is."""

    @staticmethod
    def forward(ctx, x, weight):
        n, _, h, w = x.shape
        kh, kw = weight.shape[2:]
        plo_h, plo_w = (kh - 1) // 2, (kw - 1) // 2
        dt, dev = weight.dtype, weight.device
        # JAX's conv over the 2x-dilated edge-padded source with padding (plo,
        # k - plo) and the folded kernel, as a transposed conv: the kernel
        # flipped, its in and out dims swapped; padding k + 2 crops the output
        # to the rows [plo, 2h - phi) and columns [plo, 2w - phi) that see no
        # zero padding.
        xe = F.pad(x, (1, 1, 1, 1), mode="replicate")
        folded = _folded_kernel(weight)
        y = F.conv_transpose2d(xe, folded, stride=2, padding=(kh + 2, kw + 2))
        # The border, as the reference computes it on thin strips of U: the
        # rows of the stencil's matrix that the border reads, with the
        # reference's zero padding as zero rows; two opposite sides' strips
        # in one conv.
        cols = rows = None
        if kw > 1:
            cols = _upsample2x_axis(torch.matmul(x, _constant(_strips, (w, kw), dt, dev).mT), 3)
            out = F.conv2d(cols.flatten(0, 1), weight).unflatten(0, (2, n))
            y = torch.cat([out[0, ..., :plo_w], y, out[1, ..., plo_w:]], 3)
        if kh > 1:
            rows = torch.matmul(torch.matmul(_constant(_strips, (h, kh), dt, dev), x),
                                _constant(_padded_upsample, (w, kw), dt, dev).mT)
            out = F.conv2d(rows.flatten(0, 1), weight).unflatten(0, (2, n))
            y = torch.cat([out[0, :, :, :plo_h], y, out[1, :, :, plo_h:]], 2)
        ctx.save_for_backward(xe, weight, folded, cols, rows)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xe, weight, folded, cols, rows = ctx.saved_tensors
        n, _, h, w = xe.shape
        h, w = h - 2, w - 2
        kh, kw = weight.shape[2:]
        plo_h, plo_w, phi_h, phi_w = (kh - 1) // 2, (kw - 1) // 2, kh // 2, kw // 2
        dt, dev = weight.dtype, weight.device
        gw = torch.zeros_like(weight)
        gx = torch.zeros_like(xe[:, :, 1:-1, 1:-1])
        if kh > 1:  # the top and bottom strips: their outputs' gradient, then the conv's
            g_out = g.new_zeros(2, n, g.shape[1], kh - 1, 2 * w)
            g_out[0, :, :, :plo_h] = g[:, :, :plo_h]
            g_out[1, :, :, plo_h:] = g[:, :, 2 * h - phi_h:]
            g_in, g_k, _ = torch.ops.aten.convolution_backward(
                g_out.flatten(0, 1), rows.flatten(0, 1), weight, None, [1, 1], [0, 0], [1, 1],
                False, [0, 0], 1, [True, True, False])
            gw += g_k
            gx += torch.matmul(torch.matmul(_constant(_strips, (h, kh), dt, dev).mT,
                                            g_in.unflatten(0, (2, n))),
                               _constant(_padded_upsample, (w, kw), dt, dev)).sum(0)
            g = g[:, :, plo_h:2 * h - phi_h]
        if kw > 1:  # the left and right strips of the middle rows
            g_out = g.new_zeros(2, n, g.shape[1], g.shape[2], kw - 1)
            g_out[0, ..., :plo_w] = g[..., :plo_w]
            g_out[1, ..., plo_w:] = g[..., 2 * w - phi_w:]
            g_in, g_k, _ = torch.ops.aten.convolution_backward(
                g_out.flatten(0, 1), cols.flatten(0, 1), weight, None, [1, 1], [0, 0], [1, 1],
                False, [0, 0], 1, [True, True, False])
            gw += g_k
            up = _constant(_upsample_matrix, (h,), dt, dev)
            gx += torch.matmul(torch.matmul(up.mT, g_in.unflatten(0, (2, n))),
                               _constant(_strips, (w, kw), dt, dev)).sum(0)
            g = g[..., plo_w:2 * w - phi_w]
        g_xe, g_folded, _ = torch.ops.aten.convolution_backward(
            g.contiguous(), xe, folded, None, [2, 2], [kh + 2, kw + 2], [1, 1], True, [0, 0], 1,
            [True, True, False])
        gx += _edge_pad_backward(g_xe)
        rows_t = torch.einsum("iode,xe->oidx", g_folded,
                              _constant(_flipped_stencil, (kw,), dt, dev))
        gw += torch.einsum("oidx,yd->oiyx", rows_t, _constant(_flipped_stencil, (kh,), dt, dev))
        return gx, gw


def _nhwc(fn, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]):
    y = fn(x.permute(0, 3, 1, 2), weight).permute(0, 2, 3, 1)
    return y if bias is None else y + bias


def resize2x_conv(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact conv3x3(SAME)(half_pixel_bilinear_2x(x)) without the upsample.

    x [N, h, w, Cin], weight [Cout, Cin, 3, 3] -> [N, 2h, 2w, Cout]."""
    return _nhwc(_PhaseForm.apply, x, weight, bias)


def resize2x_conv_any(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact conv(SAME)(half_pixel_bilinear_2x(x)) for any kernel size.

    x [N, h, w, Cin], weight [Cout, Cin, kh, kw] -> [N, 2h, 2w, Cout]: the
    interior by one transposed conv with the folded kernel, the border by
    the reference's conv on thin upsampled strips (O(h + w) work), assembled
    by concatenation."""
    return _nhwc(_DilatedForm.apply, x, weight, bias)


def resize2x_conv_chain(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The reference chain: the half-pixel bilinear resize to ``out_hw``
    (default 2x), then the SAME conv. x NHWC, weight OIHW."""
    xn = x.permute(0, 3, 1, 2)
    up = F.interpolate(xn, size=out_hw or (2 * xn.shape[2], 2 * xn.shape[3]), mode="bilinear",
                       align_corners=False)
    y = _conv(up, weight, "SAME").permute(0, 2, 3, 1)
    return y if bias is None else y + bias


# --------------------------------------------------------------------------
# Mixed-VJP forms: the fused forward with the materialized chain's backward.
# The two forwards are one map, so either backward is its exact gradient. The
# backward recomputes U(x) (bandwidth only), then dx = U^T(conv_x^T(g)) and
# dK = conv_K^T(g, U(x)); no forward conv is run. The JAX package puts these
# forms in no layer; they stay correct and available.
# --------------------------------------------------------------------------


def _materialized_bwd(res, g):
    """(x, weight), g (NCHW) -> (dx, dweight) through the materialized chain."""
    x, weight = res
    n, c, h, w = x.shape
    kh, kw = weight.shape[2:]
    (t, _), (l, _) = same_pads(2 * h, kh, 1), same_pads(2 * w, kw, 1)
    up = F.pad(_upsample2x(x), (l, kw - 1 - l, t, kh - 1 - t))
    dup, dweight, _ = torch.ops.aten.convolution_backward(
        g, up, weight, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [True, True, False])
    dup = dup[:, :, t:t + 2 * h, l:l + 2 * w]
    dx = torch.ops.aten.upsample_bilinear2d_backward(dup, [2 * h, 2 * w], [n, c, h, w], False,
                                                     None, None)
    return dx, dweight


class _MixedCore(torch.autograd.Function):
    """``fused``'s forward (NCHW), ``_materialized_bwd``'s backward."""

    @staticmethod
    def forward(ctx, x, weight, fused):
        ctx.save_for_backward(x, weight)
        return fused(x, weight)

    @staticmethod
    def backward(ctx, g):
        return (*_materialized_bwd(ctx.saved_tensors, g), None)


def _resize2x_conv_mixed_core(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return _MixedCore.apply(x, weight, _PhaseForm.apply)


def _resize2x_conv_any_mixed_core(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return _MixedCore.apply(x, weight, _DilatedForm.apply)


def resize2x_conv_mixed(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``resize2x_conv``'s forward with the materialized chain's backward."""
    return _nhwc(_resize2x_conv_mixed_core, x, weight, bias)


def resize2x_conv_any_mixed(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``resize2x_conv_any``'s forward with the materialized chain's backward."""
    return _nhwc(_resize2x_conv_any_mixed_core, x, weight, bias)


# --------------------------------------------------------------------------
# The layers.
# --------------------------------------------------------------------------


class Resize2xConv(Conv):
    """``resize_bilinear(x, *out_hw)`` then a 3x3 SAME ``Conv``, by the phase
    form. The parameters are the ``Conv``'s (flax ``kernel``/``bias``, OIHW
    here), so the converter and checkpoints take it as one. A ``shard``
    (tensor parallelism) splits the output channels: the fused form is
    separable by output channel, so each rank computes its block's phase
    kernels, conv and ring, then the blocks are gathered and the whole bias
    added. In bfloat16 (``dtype``) x, the kernel and the bias are cast first,
    as flax's ``promote_dtype`` does."""

    def __init__(self, in_ch: int, out_ch: int, out_hw: Tuple[int, int], device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, (3, 3), device=device, dtype=dtype)
        self.out_hw = tuple(out_hw)

    def fused(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return resize2x_conv(x, weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.shard is not None:
            x = copy_to_model(x, self.shard)
        weight, bias = self.weight, self.bias
        if dt is not None:
            x, weight, bias = x.to(dt), weight.to(dt), bias.to(dt)
        if self.out_hw == (2 * x.shape[1], 2 * x.shape[2]):
            y = self.fused(x, weight)
        else:
            y = resize2x_conv_chain(x, weight, out_hw=self.out_hw)
        if self.shard is not None:
            y = gather_features(y, self.shard)
        return y + bias


class Resize2xConvAny(Resize2xConv):
    """``resize_bilinear(x, *out_hw)`` then a SAME ``Conv`` of any kernel
    size, by the dilated form; otherwise as ``Resize2xConv``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: Tuple[int, int],
                 out_hw: Tuple[int, int], device=None, dtype: Optional[torch.dtype] = None):
        Conv.__init__(self, in_ch, out_ch, kernel_size, device=device, dtype=dtype)
        self.out_hw = tuple(out_hw)

    def fused(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return resize2x_conv_any(x, weight)
