"""Row-windowed fused paste + composite render: the CUDA kernel pair over the
sample coordinates, and its plain versions.

Replaces the Pallas TPU kernels of
``tools/pallas_research/render_windowed.py::fused_paste_render_windowed``
(``_fwd_kernel``, ``_bwd_kernel``). The function is the full-canvas render's
(``kernels/render.py``) with every per-cell term confined to the cell's row
band; outside the band the paste is exactly zero, alpha clips to 1e-8, and the
sums get that contribution in closed form:

    s1 += band(imp * rgb)
    s2 += band(imp - zp*wd*1e-8)              + sum_k zp_k*wd_k*1e-8
    s3 += band(zp*alpha*imp - zp^2*wd*1e-16)  + sum_k zp_k^2*wd_k*1e-16

It differs from the full-canvas render by two terms far below fp32 resolution
of the result: the render noise outside a band (a ~1e-10 term) and 1e-16
cross terms in the gradients of ``z_pres`` and ``depth_w``.

The band rule (``compute_bands``). A canvas row p of cell (b, k) belongs to
the paste support iff its sample coordinate ``ys[b, k, p]`` lies in
(-1, h_obj): outside, both interpolation taps clip to the same object row and
the row pastes exactly zero. The band is [first - 1, last + 2) clipped to the
canvas, where first and last are the first and last supported rows and the
one row on each side is the interpolation margin; with no supported row the
band is (0, 0) and the cell contributes its closed-form terms only. The TPU
kernel's window was a fixed 40 rows aligned to 8 (a sublane artifact, and
32-px objects on 48-px canvases only); the band here is as long as the
support, for any object and canvas size. The kernels find each band
themselves (``csrc/paste_taps.cuh::find_band``, a ballot a 32 rows);
``compute_bands`` and ``band_mask`` serve the plain versions and the tests.

What bounds the pair on an H100 SXM (LG-SPAIR config #5: B=256, K=16, 32-px
objects with 3+1 channels, 48-px canvases, fp32): the Philox noise forward
(~25 us), which binds the full pair too but is drawn here on the band rows
only (12.5 of 48 a cell with random boxes), and bytes backward, the full
pair's (~133 MB, 40 us).
``chip_smoke.py::windowed_bounds`` has the three terms, PERF.md the times.

Design (``csrc/render_windowed.cu``): ``csrc/render.cu``'s four-tap paste from
the coordinates ys [B,K,H], xs [B,K,W], restricted to each band (one body per
direction for both pairs, ``csrc/paste_taps.cuh``, banded here). The forward
takes a thread a canvas pixel and walks the cells with its sums in
registers, reading taps and drawing noise only inside a band, and saves the
sums for the backward; the backward draws each band pixel's noise once and
gathers g_obj, g_ys and g_xs from the band rows in a fixed order, without
atomics. No dense ``wy``, ``wx`` or gradient of them is formed on the card.

On a CPU tensor the wrapper computes ``render_windowed_taps_reference``; on a
CUDA tensor it launches the kernels or raises. ``render_windowed_reference``
is the dense plain form over given weights, which the tests hold against the
Pallas kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from split_vae_torch.core import tracing
from split_vae_torch.kernels.build import build as build_library
from split_vae_torch.kernels.build import check_tensor as _check
from split_vae_torch.kernels.build import stream_of as _stream
from split_vae_torch.kernels.crop import interp_matrix
from split_vae_torch.kernels.render import _NAMES, _shapes, clip_strict, paste, render_noise

# Canvas rows a block in the forward and cells a block in the backward, from
# the sweep in chip_smoke.py::time_windowed (PERF.md).
ROWS_PER_BLOCK = 4
CELLS_PER_BLOCK = 16

_EPS = 1e-8
MARGIN_ROWS = 1  # interpolation margin on each side of the support
_lib = None


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _supported(ys: torch.Tensor, h_obj: int) -> torch.Tensor:
    return (ys > -1.0) & (ys < float(h_obj))


def compute_bands(ys: torch.Tensor, h_obj: int) -> torch.Tensor:
    """Row bands [B, K, 2] int32 (start, number of rows) from the paste sample
    coordinates ``ys`` [B, K, H]; see the module docstring for the rule."""
    hh = ys.shape[-1]
    valid = _supported(ys, h_obj).to(torch.int32)
    first = torch.argmax(valid, dim=-1)
    last = hh - 1 - torch.argmax(valid.flip(-1), dim=-1)
    start = torch.clamp_min(first - MARGIN_ROWS, 0)
    end = torch.clamp_max(last + MARGIN_ROWS + 1, hh)
    some = valid.any(dim=-1)
    zero = torch.zeros_like(start)
    bands = torch.stack([torch.where(some, start, zero), torch.where(some, end - start, zero)],
                        dim=-1)
    return bands.to(torch.int32)


def band_mask(bands: torch.Tensor, hh: int) -> torch.Tensor:
    """[B, K, H] bool: the canvas rows inside each cell's band."""
    rows = torch.arange(hh, device=bands.device)
    start = bands[..., :1]
    return (rows >= start) & (rows < start + bands[..., 1:])


def render_windowed_reference(objs, wy, wx, z_pres, depth_w, bg, bands,
                              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' function in plain torch over dense weights ``wy``
    [B,K,H,h], ``wx`` [B,K,W,w], differentiable by autograd.

    ``noise`` is the scaled noise field [B,K,C,H,W] (as ``render_noise`` lays
    it out, times noise_scale), or None for none; it is used inside the bands
    only. The in-band terms are masked onto the canvas, which is the scatter
    of the band's rows.
    """
    c = objs.shape[-1] - 1
    m = band_mask(bands, wy.shape[2]).to(objs.dtype)[:, :, :, None, None]
    canvases = paste(objs, wy, wx)
    rgb = canvases[..., :c]
    alpha = clip_strict(canvases[..., c:], _EPS, 1.0)
    if noise is not None:
        rgb = rgb + noise.permute(0, 1, 3, 4, 2)
    rgb = clip_strict(rgb, 0.0, 1.0)
    zp = z_pres[:, :, None, None, None]
    wd = depth_w[:, :, None, None, None]
    transp = zp * alpha
    imp = transp * wd
    c2 = zp * wd * _EPS
    c3 = zp * zp * wd * (_EPS * _EPS)
    s1 = torch.sum(m * (imp * rgb), dim=1)
    s2 = torch.sum(m * (imp - c2), dim=1) + torch.sum(c2, dim=1)
    s3 = torch.sum(m * (transp * imp - c3), dim=1) + torch.sum(c3, dim=1)
    d = s2 + _EPS
    ac = s3 / d
    return ac * (s1 / d) + (1.0 - ac) * bg


def render_windowed_taps_reference(objs, ys, xs, z_pres, depth_w, bg,
                                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' function over the sample coordinates ys [B,K,H], xs
    [B,K,W]: the bands and the dense weights from them, then
    ``render_windowed_reference``; autograd gives the gradients of all six
    inputs (``g_ys`` exactly 0 outside each band)."""
    h, w = objs.shape[2], objs.shape[3]
    return render_windowed_reference(objs, interp_matrix(ys, h), interp_matrix(xs, w), z_pres,
                                     depth_w, bg, compute_bands(ys.detach(), h), noise)


# --------------------------------------------------------------------------
# Build and bind
# --------------------------------------------------------------------------


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library("render_windowed"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.render_windowed_fwd.argtypes = [p] * 7 + [f, p, p] + [i] * 8 + [p]
        lib.render_windowed_fwd.restype = i
        lib.render_windowed_bwd.argtypes = [p] * 7 + [f] + [p] * 8 + [i] * 8 + [p]
        lib.render_windowed_bwd.restype = i
        lib.render_windowed_error_string.argtypes = [i]
        lib.render_windowed_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _load().render_windowed_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _fwd(objs, ys, xs, z_pres, depth_w, bg, seed, noise_scale,
         rows_per_block: int = ROWS_PER_BLOCK):
    """The forward kernel: (out [B,H,W,C], sums [B,C+2,H,W])."""
    for name, t in zip(_NAMES, (objs, ys, xs, z_pres, depth_w, bg)):
        _check(t, torch.float32, name)
    _check(seed, torch.int32, "seed")
    b, k, h, w, hh, ww, c = _shapes(objs, ys, xs, z_pres, depth_w, bg)
    out = torch.empty((b, hh, ww, c), device=objs.device, dtype=torch.float32)
    sums = torch.empty((b, c + 2, hh, ww), device=objs.device, dtype=torch.float32)
    err = _load().render_windowed_fwd(
        objs.data_ptr(), ys.data_ptr(), xs.data_ptr(), z_pres.data_ptr(), depth_w.data_ptr(),
        bg.data_ptr(), seed.data_ptr(), float(noise_scale), out.data_ptr(), sums.data_ptr(),
        b, k, h, w, hh, ww, c, rows_per_block, _stream(objs))
    _raise_on(err, "render_windowed_fwd")
    tracing.count("render_windowed.fwd")
    return out, sums


def _bwd(objs, ys, xs, z_pres, depth_w, bg, seed, noise_scale, sums, g,
         cells_per_block: int = CELLS_PER_BLOCK):
    """The backward kernel: the gradients of (objs, ys, xs, z_pres, depth_w, bg)."""
    _check(g, torch.float32, "g")
    _check(sums, torch.float32, "sums")
    b, k, h, w, hh, ww, c = _shapes(objs, ys, xs, z_pres, depth_w, bg)
    for name, t, shape in (("g", g, (b, hh, ww, c)), ("sums", sums, (b, c + 2, hh, ww))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    grads = [torch.empty_like(t) for t in (objs, ys, xs, z_pres, depth_w, bg)]
    err = _load().render_windowed_bwd(
        objs.data_ptr(), ys.data_ptr(), xs.data_ptr(), z_pres.data_ptr(), depth_w.data_ptr(),
        bg.data_ptr(), seed.data_ptr(), float(noise_scale), sums.data_ptr(), g.data_ptr(),
        *(t.data_ptr() for t in grads), b, k, h, w, hh, ww, c, cells_per_block, _stream(objs))
    _raise_on(err, "render_windowed_bwd")
    tracing.count("render_windowed.bwd")
    return grads


class FusedPasteRenderWindowed(torch.autograd.Function):
    """Kernel forward, which also keeps the composite's sums; the backward
    kernel reads them and recomputes each band's paste and noise once."""

    @staticmethod
    def forward(ctx, objs, ys, xs, z_pres, depth_w, bg, seed, noise_scale):
        out, sums = _fwd(objs, ys, xs, z_pres, depth_w, bg, seed, noise_scale)
        ctx.save_for_backward(objs, ys, xs, z_pres, depth_w, bg, seed, sums)
        ctx.noise_scale = noise_scale
        return out

    @staticmethod
    def backward(ctx, g):
        *inputs, seed, sums = ctx.saved_tensors
        grads = _bwd(*inputs, seed, ctx.noise_scale, sums, g.contiguous())
        return (*grads, None, None)


def fused_paste_render_windowed(objs, ys, xs, z_pres, depth_w, bg, seed: torch.Tensor,
                                noise_scale: float) -> torch.Tensor:
    """``kernels/render.py::fused_paste_render`` with row windowing: objs
    [B,K,h,w,C+1], ys [B,K,H], xs [B,K,W] (the paste's sample coordinates in
    object pixels, ``ops/stn.py::paste_sample_coords``; ys also locates each
    cell's band), z_pres/depth_w [B,K], bg [B,H,W,C], seed int32 [1] ->
    x_recon [B,H,W,C].

    CUDA tensors launch the kernel pair; CPU tensors take the plain version
    with the same noise field.
    """
    if not objs.is_cuda:
        noise = None
        if noise_scale > 0.0:
            b, k, _, _, c1 = objs.shape
            noise = noise_scale * render_noise(seed, b, k, c1 - 1, ys.shape[2], xs.shape[2])
        return render_windowed_taps_reference(objs, ys, xs, z_pres, depth_w, bg, noise)
    args = [t.contiguous() for t in (objs, ys, xs, z_pres, depth_w, bg, seed)]
    return FusedPasteRenderWindowed.apply(*args, float(noise_scale))
