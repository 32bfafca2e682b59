"""Row-windowed fused paste + composite render: the CUDA kernel pair and its plain version.

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
the two weights cancel, so the row of ``wy`` is exactly zero. The band is
[first - 1, last + 2) clipped to the canvas, where first and last are the
first and last supported rows and the one row on each side is the
interpolation margin; with no supported row the band is (0, 0) and the cell
contributes its closed-form terms only. The TPU kernel's window was a fixed
40 rows aligned to 8 (a sublane artifact, and 32-px objects on 48-px canvases
only); the band here is as long as the support, for any object and canvas
size.

What bounds it on an H100 SXM (LG-SPAIR config #5: B=256, K=16, 32-px objects
with 3+1 channels, 48-px canvases, fp32): the bytes are the full render's
less the rows of ``wy`` outside the bands (~113 MB, ~0.034 ms forward; ~238
MB, ~0.071 ms backward); the dense products all scale with the band length,
because the kernel forms u = wy[band] . obj first and paste = u . wx^T second
(20 KFLOP a band row forward, 61 KFLOP backward). So the forward is bound by
bytes for bands up to 27 rows, the longest a box of the model can give, and
the backward up to a mean of 19 rows; random boxes give 12.5. PERF.md has the
measured times.

Design (``csrc/render_windowed.cu``): one block per image walking its cells
in order, so overlapping bands add in a fixed order with no atomics; the
sums in shared memory indexed by the absolute row; tiles sized for a band of
the whole canvas and masked; the Philox noise of ``csrc/philox.cuh`` at the
absolute position, so this kernel and the full-canvas one see the same noise
where it matters; ``g_wy`` written in full, zeros outside the band.

On a CPU tensor the wrapper computes ``render_windowed_reference``; on a CUDA
tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from split_vae_torch.kernels.build import build as build_library
from split_vae_torch.kernels.build import check_tensor as _check
from split_vae_torch.kernels.build import stream_of as _stream
from split_vae_torch.kernels.render import clip_strict, paste, render_noise

# Launch counts of the forward and backward kernels: each wrapper adds one
# where it launches its kernel, and nowhere else.
fwd_launches = 0
bwd_launches = 0

_EPS = 1e-8
MARGIN_ROWS = 1  # interpolation margin on each side of the support
_lib = None


def compute_bands(ys: torch.Tensor, h_obj: int) -> torch.Tensor:
    """Row bands [B, K, 2] int32 (start, number of rows) from the paste sample
    coordinates ``ys`` [B, K, H]; see the module docstring for the rule."""
    hh = ys.shape[-1]
    valid = ((ys > -1.0) & (ys < float(h_obj))).to(torch.int32)
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
    """The kernels' function in plain torch, differentiable by autograd.

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


# --------------------------------------------------------------------------
# Build and bind
# --------------------------------------------------------------------------


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library("render_windowed"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.render_windowed_fwd.argtypes = [p] * 8 + [f, p] + [i] * 7 + [p]
        lib.render_windowed_fwd.restype = i
        lib.render_windowed_bwd.argtypes = [p] * 8 + [f] + [p] * 8 + [i] * 7 + [p]
        lib.render_windowed_bwd.restype = i
        lib.render_windowed_error_string.argtypes = [i]
        lib.render_windowed_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _load().render_windowed_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _shapes(objs, wy, wx, z_pres, depth_w, bg):
    b, k, h, w, c1 = objs.shape
    hh, ww = wy.shape[2], wx.shape[2]
    want = {"wy": (b, k, hh, h), "wx": (b, k, ww, w), "z_pres": (b, k),
            "depth_w": (b, k), "bg": (b, hh, ww, c1 - 1)}
    got = {"wy": wy, "wx": wx, "z_pres": z_pres, "depth_w": depth_w, "bg": bg}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(got[name].shape)}")
    if c1 - 1 not in (1, 3):
        raise ValueError(f"render kernels take 1 or 3 colour channels, got {c1 - 1}")
    return b, k, h, w, hh, ww, c1 - 1


def _check_bands(bands: torch.Tensor, b: int, k: int) -> None:
    _check(bands, torch.int32, "bands")
    if tuple(bands.shape) != (b, k, 2):
        raise ValueError(f"bands: expected shape {(b, k, 2)}, got {tuple(bands.shape)}")


def _fwd(objs, wy, wx, z_pres, depth_w, bg, bands, seed, noise_scale):
    global fwd_launches
    for name, t in zip(("objs", "wy", "wx", "z_pres", "depth_w", "bg"),
                       (objs, wy, wx, z_pres, depth_w, bg)):
        _check(t, torch.float32, name)
    _check(seed, torch.int32, "seed")
    b, k, h, w, hh, ww, c = _shapes(objs, wy, wx, z_pres, depth_w, bg)
    _check_bands(bands, b, k)
    lib = _load()
    out = torch.empty((b, hh, ww, c), device=objs.device, dtype=torch.float32)
    err = lib.render_windowed_fwd(
        objs.data_ptr(), wy.data_ptr(), wx.data_ptr(), z_pres.data_ptr(), depth_w.data_ptr(),
        bg.data_ptr(), bands.data_ptr(), seed.data_ptr(), float(noise_scale), out.data_ptr(),
        b, k, h, w, hh, ww, c, _stream(objs))
    _raise_on(err, "render_windowed_fwd")
    fwd_launches += 1
    return out


def _bwd(objs, wy, wx, z_pres, depth_w, bg, bands, seed, noise_scale, g):
    global bwd_launches
    _check(g, torch.float32, "g")
    b, k, h, w, hh, ww, c = _shapes(objs, wy, wx, z_pres, depth_w, bg)
    _check_bands(bands, b, k)
    lib = _load()
    # The kernel writes every entry, the zeros of g_wy outside the bands too.
    grads = [torch.empty_like(t) for t in (objs, wy, wx, z_pres, depth_w, bg)]
    # The composite's gradients (C + 2 planes an image), passed from the
    # kernel's first pass to its second.
    scratch = torch.empty((b, c + 2, hh, ww), device=objs.device, dtype=torch.float32)
    err = lib.render_windowed_bwd(
        objs.data_ptr(), wy.data_ptr(), wx.data_ptr(), z_pres.data_ptr(), depth_w.data_ptr(),
        bg.data_ptr(), bands.data_ptr(), seed.data_ptr(), float(noise_scale), g.data_ptr(),
        *(t.data_ptr() for t in grads), scratch.data_ptr(), b, k, h, w, hh, ww, c, _stream(objs))
    _raise_on(err, "render_windowed_bwd")
    bwd_launches += 1
    return grads


class FusedPasteRenderWindowed(torch.autograd.Function):
    """Kernel forward; the backward kernel recomputes the pastes and noise.
    ``bands`` and ``seed`` get no gradient."""

    @staticmethod
    def forward(ctx, objs, wy, wx, z_pres, depth_w, bg, bands, seed, noise_scale):
        ctx.save_for_backward(objs, wy, wx, z_pres, depth_w, bg, bands, seed)
        ctx.noise_scale = noise_scale
        return _fwd(objs, wy, wx, z_pres, depth_w, bg, bands, seed, noise_scale)

    @staticmethod
    def backward(ctx, g):
        *inputs, bands, seed = ctx.saved_tensors
        grads = _bwd(*inputs, bands, seed, ctx.noise_scale, g.contiguous())
        return (*grads, None, None, None)


def fused_paste_render_windowed(objs, wy, wx, z_pres, depth_w, bg, seed: torch.Tensor,
                                ys: torch.Tensor, noise_scale: float) -> torch.Tensor:
    """``kernels/render.py::fused_paste_render`` with row windowing, over the
    dense weights ``wy`` [B,K,H,h], ``wx`` [B,K,W,w] (``interp_matrix`` of the
    sample coordinates), and ``ys`` [B,K,H], the paste's row sample
    coordinates (``ops/stn.py::paste_sample_coords``), which locate each
    cell's band;
    ``ys`` gets no gradient. CUDA tensors launch the kernel pair; CPU tensors
    take the plain version with the same noise field.
    """
    bands = compute_bands(ys.detach(), objs.shape[2])
    if not objs.is_cuda:
        noise = None
        if noise_scale > 0.0:
            b, k, _, _, c1 = objs.shape
            noise = noise_scale * render_noise(seed, b, k, c1 - 1, wy.shape[2], wx.shape[2])
        return render_windowed_reference(objs, wy, wx, z_pres, depth_w, bg, bands, noise)
    args = [t.contiguous() for t in (objs, wy, wx, z_pres, depth_w, bg, bands, seed)]
    return FusedPasteRenderWindowed.apply(*args, float(noise_scale))
