"""Fused paste + composite render: the CUDA kernel pair and its plain version.

Replaces the Pallas TPU kernels
``split_vae_tpu/ops/pallas/render_packed.py::fused_paste_render_packed``
(``_fwd_kernel``, ``_bwd_kernel``) and, for shapes that are not multiples of 8,
``split_vae_tpu/ops/pallas/render_fused.py::fused_paste_render``: the CUDA
kernels in ``csrc/render.cu`` take any object and canvas size.

What bounds it on an H100 SXM (LG-SPAIR config #5: B=256, K=16, 32-px
objects with 3+1 channels, 48-px canvases, fp32):

- forward: ~132 MB moved (objs 67 MB, Wy and Wx 50 MB, bg and out 14 MB),
  ~39 us at 3.35 TB/s; ~4.0 GFLOP of dense products (obj.Wx^T then Wy.tmp,
  0.98 MFLOP per cell), ~60 us at 67 TFLOP/s fp32 without tensor cores. So
  it is bound by operations.
- backward: ~255 MB moved (the inputs and g, and gradients shaped as the
  inputs), ~76 us; one paste (4.0 GFLOP) plus the four gradient products
  gp.Wx, Wy^T.(gp.Wx), Wy.obj and gp^T.(Wy.obj), gp.tmp^T (10.5 GFLOP),
  ~14.5 GFLOP, ~216 us. Bound by operations.

Design: one block per image with a loop over the cells, so the per-cell
canvases [B, K, H, W, C+1] never reach device memory (the point of the TPU
kernel too). Each thread keeps its pixels' three sums in registers; the
shared-memory arrays have odd row lengths and the threads' rows and columns
are strided, so the small products read shared memory without bank
conflicts. The backward recomputes each paste instead of keeping the K
pastes, which would not fit in shared memory, and regenerates the render
noise from a counter-based Philox keyed by (seed + image), so forward and
backward see the same noise with no state. Plain fp32 FMAs, no tensor cores:
on an H100 (700 W) the forward runs ~10x its bound and the backward ~12x
(PERF.md); overlapping the staging of the next cell with the products is the
next step.

On a CPU tensor the wrapper computes ``render_reference`` (with the same
noise field, from a numpy Philox); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from split_vae_torch.kernels.build import build as build_library
from split_vae_torch.kernels.build import check_tensor as _check
from split_vae_torch.kernels.build import stream_of as _stream

# Launch counts of the forward and backward kernels: each wrapper adds one
# where it launches its kernel, and nowhere else.
fwd_launches = 0
bwd_launches = 0

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
    the same numbers.
    """
    if not seed.is_cuda:
        return torch.from_numpy(render_noise_reference(int(seed.reshape(-1)[0]), b, k, c, h, w))
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
        lib.render_fwd.argtypes = [p] * 7 + [f, p] + [i] * 7 + [p]
        lib.render_fwd.restype = i
        lib.render_bwd.argtypes = [p] * 7 + [f] + [p] * 8 + [i] * 7 + [p]
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


def _fwd(objs, wy, wx, z_pres, depth_w, bg, seed, noise_scale):
    global fwd_launches
    for name, t in zip(("objs", "wy", "wx", "z_pres", "depth_w", "bg"),
                       (objs, wy, wx, z_pres, depth_w, bg)):
        _check(t, torch.float32, name)
    _check(seed, torch.int32, "seed")
    b, k, h, w, hh, ww, c = _shapes(objs, wy, wx, z_pres, depth_w, bg)
    lib = _load()
    out = torch.empty((b, hh, ww, c), device=objs.device, dtype=torch.float32)
    err = lib.render_fwd(objs.data_ptr(), wy.data_ptr(), wx.data_ptr(), z_pres.data_ptr(),
                         depth_w.data_ptr(), bg.data_ptr(), seed.data_ptr(), float(noise_scale),
                         out.data_ptr(), b, k, h, w, hh, ww, c, _stream(objs))
    _raise_on(err, "render_fwd")
    fwd_launches += 1
    return out


def _bwd(objs, wy, wx, z_pres, depth_w, bg, seed, noise_scale, g):
    global bwd_launches
    _check(g, torch.float32, "g")
    b, k, h, w, hh, ww, c = _shapes(objs, wy, wx, z_pres, depth_w, bg)
    lib = _load()
    grads = [torch.empty_like(t) for t in (objs, wy, wx, z_pres, depth_w, bg)]
    # The composite's gradients (C + 2 planes an image), passed from the
    # kernel's first pass to its second.
    scratch = torch.empty((b, c + 2, hh, ww), device=objs.device, dtype=torch.float32)
    err = lib.render_bwd(objs.data_ptr(), wy.data_ptr(), wx.data_ptr(), z_pres.data_ptr(),
                         depth_w.data_ptr(), bg.data_ptr(), seed.data_ptr(), float(noise_scale),
                         g.data_ptr(), *(t.data_ptr() for t in grads), scratch.data_ptr(),
                         b, k, h, w, hh, ww, c, _stream(objs))
    _raise_on(err, "render_bwd")
    bwd_launches += 1
    return grads


class FusedPasteRender(torch.autograd.Function):
    """Kernel forward; the backward kernel recomputes the pastes and noise."""

    @staticmethod
    def forward(ctx, objs, wy, wx, z_pres, depth_w, bg, seed, noise_scale):
        ctx.save_for_backward(objs, wy, wx, z_pres, depth_w, bg, seed)
        ctx.noise_scale = noise_scale
        return _fwd(objs, wy, wx, z_pres, depth_w, bg, seed, noise_scale)

    @staticmethod
    def backward(ctx, g):
        objs, wy, wx, z_pres, depth_w, bg, seed = ctx.saved_tensors
        grads = _bwd(objs, wy, wx, z_pres, depth_w, bg, seed, ctx.noise_scale,
                     g.contiguous())
        return (*grads, None, None)


def fused_paste_render(objs, wy, wx, z_pres, depth_w, bg, seed: torch.Tensor,
                       noise_scale: float) -> torch.Tensor:
    """objs [B,K,h,w,C+1], wy [B,K,H,h], wx [B,K,W,w], z_pres/depth_w [B,K],
    bg [B,H,W,C], seed int32 [1] -> x_recon [B,H,W,C].

    CUDA tensors launch the kernel pair; CPU tensors take the plain version
    with the same noise field.
    """
    if not objs.is_cuda:
        noise = None
        if noise_scale > 0.0:
            b, k, _, _, c1 = objs.shape
            noise = noise_scale * render_noise(seed, b, k, c1 - 1, wy.shape[2], wx.shape[2])
        return render_reference(objs, wy, wx, z_pres, depth_w, bg, noise)
    args = [t.contiguous() for t in (objs, wy, wx, z_pres, depth_w, bg, seed)]
    return FusedPasteRender.apply(*args, float(noise_scale))
