"""Fused paste + composite render: the CUDA kernel pair over the sample
coordinates, and its plain versions.

    paste[b,k,y,x,c] = sum_{i,j} wy[b,k,y,i] * obj[b,k,i,j,c] * wx[b,k,x,j]
    wy = interp_matrix(ys, h), wx = interp_matrix(xs, w)

then the depth-aware alpha composite over the background with the seeded
render noise. Replaces the Pallas TPU kernels
``split_vae_tpu/ops/pallas/render_packed.py::fused_paste_render_packed``
(``_fwd_kernel``, ``_bwd_kernel``) and, for shapes that are not multiples of 8,
``split_vae_tpu/ops/pallas/render_fused.py::fused_paste_render``, which take
the dense ``wy``, ``wx`` and multiply them out. Every row of those holds at
most two non-zeros, so the kernels in ``csrc/render.cu`` take the paste's
sample coordinates ys [B,K,H] and xs [B,K,W] (``ops/stn.py::
paste_sample_coords``) and read four taps a canvas pixel; the dense matrices
and their dense gradients are never formed on the card. The taps are
``interp_matrix``'s in fp32, out-of-object rule included (where a
coordinate's two clamped taps coincide its row or column pastes exactly 0).

What bounds the pair on an H100 SXM (LG-SPAIR config #5: B=256, K=16, 32-px
objects with 3+1 channels, 48-px canvases, fp32) is the render noise: 28.3 M
Philox normals a call, each 111 instructions a lane (sm_90a SASS), against
~57 MB forward and ~133 MB backward (17 and 40 us at 3.35 TB/s; of the
objects only the sectors that random boxes' taps read, ~30 of 67 MB) and a
few hundred MFLOP. ``chip_smoke.py::bounds`` has the three terms.

Design (``csrc/render.cu``): the forward takes a thread a canvas pixel, walks
the cells in order with the sums in registers, reads the four taps straight
from device memory (16 bytes each) where both taps lie in the object, repeats
the dense einsums' roundings, and also writes the sums S1, S2, S3 (C+2
planes an image) for the backward. The backward reads those sums, so it
generates the noise once, not twice: a block takes CELLS_PER_BLOCK cells of
an image, recomputes each cell's paste and noise a thread a pixel, keeps the
paste's gradient in shared memory and gathers g_obj, g_ys and g_xs from it in
a fixed order, without atomics. Measured times are in PERF.md.

On a CPU tensor the wrapper computes ``render_taps_reference`` (with the same
noise field, from a numpy Philox) and autograd through it; on a CUDA tensor it
launches the kernels or raises. ``render_reference`` is the dense plain form
over given weights, which the tests hold against the Pallas kernels.

Channels: the kernels take any C from 1 to MAX_CHANNELS, as the Pallas kernels
take any ``num_channel``; C = 1 and 3 run instances of their own (8- and
16-byte pixel accesses), any other C a general one that loads channel by
channel (``csrc/paste_taps.cuh``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from split_vae_torch.core import tracing
from split_vae_torch.kernels.build import build as build_library
from split_vae_torch.kernels.build import check_tensor as _check
from split_vae_torch.kernels.build import stream_of as _stream
from split_vae_torch.kernels.crop import interp_matrix

# Canvas rows a block in the forward and cells a block in the backward, from
# the sweep in chip_smoke.py::time_render (PERF.md).
ROWS_PER_BLOCK = 8
CELLS_PER_BLOCK = 16
# The most colour channels the kernels take (csrc/paste_taps.cuh::
# kMaxChannels): C = 1 and 3 have instances of their own, any other C up to
# this one runs the general instance, whose per-channel arrays have this size.
MAX_CHANNELS = 8

_EPS = 1e-8
_lib = None


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------


def clip_strict(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip(x, lo, hi) whose gradient passes only where lo < x < hi.

    The kernels gate their masks strictly (as the TPU kernels do); torch.clamp
    would pass the gradient at the bounds too.
    """
    return torch.where((x > lo) & (x < hi), x, x.detach().clamp(lo, hi))


def composite(canvases: torch.Tensor, z_pres: torch.Tensor, depth_w: torch.Tensor,
              bg: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depth-aware alpha composite of per-cell canvases.

    canvases [B,K,H,W,C+1] (RGB then alpha), z_pres/depth_w [B,K], bg
    broadcastable to [B,H,W,C], noise (already scaled) [B,K,H,W,C] or None.
    Math of nn/spair_nets.py::render in the JAX package.
    """
    c = canvases.shape[-1] - 1
    rgb = canvases[..., :c]
    alpha = clip_strict(canvases[..., c:], _EPS, 1.0)
    if noise is not None:
        rgb = rgb + noise
    rgb = clip_strict(rgb, 0.0, 1.0)
    zp = z_pres[:, :, None, None, None]
    wd = depth_w[:, :, None, None, None]
    transp = zp * alpha
    imp = transp * wd
    s1 = torch.sum(imp * rgb, dim=1)
    s2 = torch.sum(imp, dim=1)
    s3 = torch.sum(transp * imp, dim=1)
    d = s2 + _EPS
    ac = s3 / d
    return ac * (s1 / d) + (1.0 - ac) * bg


def paste(objs: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """objs [B,K,h,w,C1], wy [B,K,H,h], wx [B,K,W,w] -> canvases [B,K,H,W,C1]."""
    tmp = torch.einsum("bkpi,bkijc->bkpjc", wy, objs)
    return torch.einsum("bkpjc,bkqj->bkpqc", tmp, wx)


def render_reference(objs, wy, wx, z_pres, depth_w, bg,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain torch: paste, then composite.

    ``noise`` is the scaled noise field [B,K,C,H,W] (as ``render_noise``
    lays it out, times noise_scale), or None for none.
    """
    if noise is not None:
        noise = noise.permute(0, 1, 3, 4, 2)
    return composite(paste(objs, wy, wx), z_pres, depth_w, bg, noise)


def render_taps_reference(objs, ys, xs, z_pres, depth_w, bg,
                          noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' function over the sample coordinates ys [B,K,H], xs
    [B,K,W]: the dense weights from them, then ``render_reference``; autograd
    gives the gradients of all six inputs."""
    return render_reference(objs, interp_matrix(ys, objs.shape[2]),
                            interp_matrix(xs, objs.shape[3]), z_pres, depth_w, bg, noise)


# --------------------------------------------------------------------------
# Render noise: Philox-4x32-10, key seed + b, counter ((k*C + c)*H + y)*W + x
# --------------------------------------------------------------------------

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = np.uint64(0xFFFFFFFF)


def _philox_normal(keys: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """numpy twin of csrc/render.cu::normal_at, broadcast over keys and pos."""
    c0 = np.broadcast_to(pos.astype(np.uint64), np.broadcast(keys, pos).shape).copy()
    c1 = np.zeros_like(c0)
    c2 = np.zeros_like(c0)
    c3 = np.zeros_like(c0)
    k0 = keys.astype(np.uint64)
    k1 = np.uint64(0)
    for _ in range(10):
        p0 = _M0 * c0
        p1 = _M1 * c2
        hi0, lo0 = p0 >> np.uint64(32), p0 & _MASK
        hi1, lo1 = p1 >> np.uint64(32), p1 & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + np.uint64(_W0)) & _MASK
        k1 = (k1 + np.uint64(_W1)) & _MASK
    scale = np.float32(2.3283064365386963e-10)
    u1 = (c0.astype(np.float32) + np.float32(0.5)) * scale
    u2 = (c1.astype(np.float32) + np.float32(0.5)) * scale
    r = np.sqrt(np.float32(-2.0) * np.log(u1))
    return (r * np.cos(np.float32(6.283185307179586) * u2)).astype(np.float32)


def render_noise_reference(seed: int, b: int, k: int, c: int, h: int, w: int) -> np.ndarray:
    """The standard-normal field [B,K,C,H,W] that the kernels add, in numpy."""
    keys = ((np.uint64(seed) + np.arange(b, dtype=np.uint64)) & _MASK)[:, None]
    pos = np.arange(k * c * h * w, dtype=np.uint64)[None, :]
    return _philox_normal(keys, pos).reshape(b, k, c, h, w)


def render_noise(seed: torch.Tensor, b: int, k: int, c: int, h: int, w: int) -> torch.Tensor:
    """Standard-normal render noise [B,K,C,H,W] for an int32 ``seed`` tensor.

    On a CUDA seed the kernel writes the field; on a CPU seed numpy computes
    the same numbers (a negative seed read as the uint32 the kernels add).
    """
    if not seed.is_cuda:
        key = int(seed.reshape(-1)[0]) & 0xFFFFFFFF
        return torch.from_numpy(render_noise_reference(key, b, k, c, h, w))
    _check(seed, torch.int32, "seed")
    out = torch.empty((b, k, c, h, w), device=seed.device, dtype=torch.float32)
    err = _load().render_noise(seed.data_ptr(), out.data_ptr(), b, k, c, h, w, _stream(seed))
    _raise_on(err, "render_noise")
    return out


# --------------------------------------------------------------------------
# Build and bind
# --------------------------------------------------------------------------


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library("render"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.render_fwd.argtypes = [p] * 7 + [f, p, p] + [i] * 8 + [p]
        lib.render_fwd.restype = i
        lib.render_bwd.argtypes = [p] * 7 + [f] + [p] * 8 + [i] * 8 + [p]
        lib.render_bwd.restype = i
        lib.render_noise.argtypes = [p, p] + [i] * 5 + [p]
        lib.render_noise.restype = i
        lib.render_error_string.argtypes = [i]
        lib.render_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _load().render_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


_NAMES = ("objs", "ys", "xs", "z_pres", "depth_w", "bg")


def _shapes(objs, ys, xs, z_pres, depth_w, bg):
    if objs.dim() != 5 or ys.dim() != 3 or xs.dim() != 3:
        raise ValueError(f"need objs [B,K,h,w,C+1], ys [B,K,H], xs [B,K,W]; got "
                         f"{tuple(objs.shape)}, {tuple(ys.shape)}, {tuple(xs.shape)}")
    b, k, h, w, c1 = objs.shape
    hh, ww = ys.shape[2], xs.shape[2]
    want = {"ys": (b, k, hh), "xs": (b, k, ww), "z_pres": (b, k), "depth_w": (b, k),
            "bg": (b, hh, ww, c1 - 1)}
    for name, t in zip(_NAMES[1:], (ys, xs, z_pres, depth_w, bg)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: expected shape {want[name]}, got {tuple(t.shape)}")
    if not 1 <= c1 - 1 <= MAX_CHANNELS:
        raise ValueError(f"render kernels take 1 to MAX_CHANNELS = {MAX_CHANNELS} colour "
                         f"channels, got {c1 - 1}")
    return b, k, h, w, hh, ww, c1 - 1


def _fwd(objs, ys, xs, z_pres, depth_w, bg, seed, noise_scale,
         rows_per_block: int = ROWS_PER_BLOCK):
    """The forward kernel: (out [B,H,W,C], sums [B,C+2,H,W])."""
    for name, t in zip(_NAMES, (objs, ys, xs, z_pres, depth_w, bg)):
        _check(t, torch.float32, name)
    _check(seed, torch.int32, "seed")
    b, k, h, w, hh, ww, c = _shapes(objs, ys, xs, z_pres, depth_w, bg)
    out = torch.empty((b, hh, ww, c), device=objs.device, dtype=torch.float32)
    sums = torch.empty((b, c + 2, hh, ww), device=objs.device, dtype=torch.float32)
    err = _load().render_fwd(objs.data_ptr(), ys.data_ptr(), xs.data_ptr(), z_pres.data_ptr(),
                             depth_w.data_ptr(), bg.data_ptr(), seed.data_ptr(),
                             float(noise_scale), out.data_ptr(), sums.data_ptr(),
                             b, k, h, w, hh, ww, c, rows_per_block, _stream(objs))
    _raise_on(err, "render_fwd")
    tracing.count("render.fwd")
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
    err = _load().render_bwd(objs.data_ptr(), ys.data_ptr(), xs.data_ptr(), z_pres.data_ptr(),
                             depth_w.data_ptr(), bg.data_ptr(), seed.data_ptr(),
                             float(noise_scale), sums.data_ptr(), g.data_ptr(),
                             *(t.data_ptr() for t in grads), b, k, h, w, hh, ww, c,
                             cells_per_block, _stream(objs))
    _raise_on(err, "render_bwd")
    tracing.count("render.bwd")
    return grads


class FusedPasteRender(torch.autograd.Function):
    """Kernel forward, which also keeps the composite's sums; the backward
    kernel reads them and recomputes each paste and its noise once."""

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


def fused_paste_render(objs, ys, xs, z_pres, depth_w, bg, seed: torch.Tensor,
                       noise_scale: float) -> torch.Tensor:
    """objs [B,K,h,w,C+1], ys [B,K,H], xs [B,K,W] (the paste's sample
    coordinates in object pixels), z_pres/depth_w [B,K], bg [B,H,W,C], seed
    int32 [1] -> x_recon [B,H,W,C].

    CUDA tensors launch the kernel pair; CPU tensors take the plain version
    with the same noise field.
    """
    if not objs.is_cuda:
        noise = None
        if noise_scale > 0.0:
            b, k, _, _, c1 = objs.shape
            noise = noise_scale * render_noise(seed, b, k, c1 - 1, ys.shape[2], xs.shape[2])
        return render_taps_reference(objs, ys, xs, z_pres, depth_w, bg, noise)
    args = [t.contiguous() for t in (objs, ys, xs, z_pres, depth_w, bg, seed)]
    return FusedPasteRender.apply(*args, float(noise_scale))
