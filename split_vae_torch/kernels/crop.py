"""STN glimpse crop: the CUDA kernel pair over the sample coordinates, and its
plain versions.

    glimpse[b,k,p,q,c] = sum_{i,j} wy[b,k,p,i] * img[b,i,j,c] * wx[b,k,q,j]
    wy = interp_matrix(ys, H), wx = interp_matrix(xs, W)

Every row of ``wy`` and ``wx`` holds at most two non-zeros, so the kernels in
``csrc/crop.cu`` take the sample coordinates ys [B,K,ho] and xs [B,K,wo] and
gather four taps an output; the dense matrices and their dense gradients are
never formed. They replace the Pallas TPU kernels
``tools/pallas_research/crop_fused.py`` (``_fwd_kernel:33``,
``_bwd_kernel:42``) and ``tools/pallas_research/crop_packed.py``
(``_fwd_kernel:64``, ``_bwd_kernel:80``), which multiply the dense matrices
out; the packed one is the TPU's 8-row sublane layout of the same function.

The taps are ``interp_matrix``'s in fp32, out-of-image rule included: where
the two clamped indices of a coordinate coincide (in (-1, 0), at or beyond
n-1, or further out), the row and its gradient are exactly 0. That is the
reference's clipping, not ``F.grid_sample``'s zero padding, which differs at
the border.

What bounds the kernels on an H100 SXM (3.35 TB/s, 700 W; B=256, K=16,
48 -> 32 px, C=3, fp32): bytes. Forward 58.5 MB (17.45 us), backward
without g_img 59.5 MB (17.76 us), with it 66.6 MB (19.88 us). The design
(csrc/crop.cu) spends few instructions an output, which is what held the
first versions back: the image staged in shared memory, a warp on four
output rows at a time with a lane a column and its taps in registers, 16-byte
stores and cp.async loads of g, sums over rows and columns in a fixed order
without atomics. Measured times are in PERF.md.

On a CPU tensor ``StnCropTaps`` computes the plain version
(``crop_taps_reference`` and autograd through it); on a CUDA tensor it
launches the kernels or raises. ``crop_reference`` and
``crop_backward_reference`` are the dense plain forms over given weights.
"""

from __future__ import annotations

import ctypes

import torch

from split_vae_torch.core import tracing
from split_vae_torch.kernels.build import build as build_library
from split_vae_torch.kernels.build import check_tensor, stream_of

# Cells a block in the forward and in the backward without g_img, from the
# sweep in chip_smoke.py::time_crop (PERF.md).
CELLS_PER_BLOCK_FWD = 8
CELLS_PER_BLOCK_BWD = 4
MAX_COLUMNS = 128

_lib = None


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def interp_matrix(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """Bilinear weight rows [..., n_out, in_size] for sample positions coords [..., n_out]."""
    x0 = torch.floor(coords)
    x1 = x0 + 1.0
    x0c = torch.clamp(x0, 0.0, in_size - 1.0)
    x1c = torch.clamp(x1, 0.0, in_size - 1.0)
    w0 = x1c - coords
    w1 = coords - x0c
    idx = torch.arange(in_size, device=coords.device)
    one_hot0 = (x0c.long()[..., None] == idx).to(coords.dtype)
    one_hot1 = (x1c.long()[..., None] == idx).to(coords.dtype)
    return w0[..., None] * one_hot0 + w1[..., None] * one_hot1


def crop_reference(img: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """img [B,H,W,C], wy [B,K,ho,H], wx [B,K,wo,W] -> glimpses [B,K,ho,wo,C]."""
    tmp = torch.einsum("bkpi,bijc->bkpjc", wy, img)
    return torch.einsum("bkpjc,bkqj->bkpqc", tmp, wx)


def crop_backward_reference(img, wy, wx, g, need_img: bool = True):
    """(g_img or None, g_wy, g_wx) of ``crop_reference`` for the cotangent g [B,K,ho,wo,C]."""
    t = torch.einsum("bkpqc,bkqj->bkpjc", g, wx)
    g_img = torch.einsum("bkpi,bkpjc->bijc", wy, t) if need_img else None
    g_wy = torch.einsum("bkpjc,bijc->bkpi", t, img)
    tmp = torch.einsum("bkpi,bijc->bkpjc", wy, img)
    g_wx = torch.einsum("bkpqc,bkpjc->bkqj", g, tmp)
    return g_img, g_wy, g_wx


def crop_taps_reference(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img [B,H,W,C], ys [B,K,ho], xs [B,K,wo] -> glimpses [B,K,ho,wo,C]: the
    dense weights from the coordinates, then ``crop_reference``; autograd gives
    the gradients of all three inputs."""
    return crop_reference(img, interp_matrix(ys, img.shape[1]), interp_matrix(xs, img.shape[2]))


def crop_taps_backward_reference(img, ys, xs, g, need_img: bool = True):
    """(g_img or None, g_ys, g_xs) of ``crop_taps_reference``, by autograd."""
    with torch.enable_grad():
        ins = [img.detach().requires_grad_(need_img), ys.detach().requires_grad_(True),
               xs.detach().requires_grad_(True)]
        wanted = [t for t in ins if t.requires_grad]
        grads = list(torch.autograd.grad(crop_taps_reference(*ins), wanted, g))
    return (grads.pop(0) if need_img else None), grads[0], grads[1]


# --------------------------------------------------------------------------
# Build and bind
# --------------------------------------------------------------------------


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library("crop"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crop_fwd.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.crop_fwd.restype = i
        lib.crop_bwd.argtypes = [p] * 7 + [i] * 8 + [p]
        lib.crop_bwd.restype = i
        lib.crop_error_string.argtypes = [i]
        lib.crop_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _load().crop_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _shapes(img, ys, xs):
    if img.dim() != 4 or ys.dim() != 3 or xs.dim() != 3:
        raise ValueError(f"need img [B,H,W,C], ys [B,K,ho], xs [B,K,wo]; got "
                         f"{tuple(img.shape)}, {tuple(ys.shape)}, {tuple(xs.shape)}")
    b, h, w, c = img.shape
    k, ho, wo = ys.shape[1], ys.shape[2], xs.shape[2]
    for name, t, shape in (("ys", ys, (b, k, ho)), ("xs", xs, (b, k, wo))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    return b, k, h, w, ho, wo, c


def _kernel_shapes(img, ys, xs):
    """_shapes, and the kernels' own limit: a lane a column, four slots a lane."""
    shapes = _shapes(img, ys, xs)
    if shapes[5] > MAX_COLUMNS:
        raise ValueError(f"xs: the kernels take at most {MAX_COLUMNS} output columns, got "
                         f"{shapes[5]}")
    return shapes


def _fwd(img, ys, xs, cells_per_block: int = CELLS_PER_BLOCK_FWD):
    for name, t in (("img", img), ("ys", ys), ("xs", xs)):
        check_tensor(t, torch.float32, name)
    b, k, h, w, ho, wo, c = _kernel_shapes(img, ys, xs)
    out = torch.empty((b, k, ho, wo, c), device=img.device, dtype=torch.float32)
    err = _load().crop_fwd(img.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
                           b, k, h, w, ho, wo, c, cells_per_block, stream_of(img))
    _raise_on(err, "crop_fwd")
    tracing.count("crop.fwd")
    return out


def _bwd(img, ys, xs, g, need_img: bool = True, cells_per_block: int = CELLS_PER_BLOCK_BWD):
    """The backward kernel: (g_img or None, g_ys, g_xs)."""
    for name, t in (("img", img), ("ys", ys), ("xs", xs), ("g", g)):
        check_tensor(t, torch.float32, name)
    b, k, h, w, ho, wo, c = _kernel_shapes(img, ys, xs)
    if tuple(g.shape) != (b, k, ho, wo, c):
        raise ValueError(f"g: expected shape {(b, k, ho, wo, c)}, got {tuple(g.shape)}")
    g_img = torch.empty_like(img) if need_img else None
    g_ys, g_xs = torch.empty_like(ys), torch.empty_like(xs)
    err = _load().crop_bwd(img.data_ptr(), ys.data_ptr(), xs.data_ptr(), g.data_ptr(),
                           g_img.data_ptr() if need_img else None, g_ys.data_ptr(),
                           g_xs.data_ptr(), b, k, h, w, ho, wo, c, cells_per_block,
                           stream_of(img))
    _raise_on(err, "crop_bwd")
    tracing.count("crop.bwd")
    return g_img, g_ys, g_xs


class StnCropTaps(torch.autograd.Function):
    """The crop over (img, ys, xs) with its hand-written backward: kernels on a
    GPU, the plain version on the CPU."""

    @staticmethod
    def forward(ctx, img, ys, xs):
        _shapes(img, ys, xs)
        ctx.save_for_backward(img, ys, xs)
        return _fwd(img, ys, xs) if img.is_cuda else crop_taps_reference(img, ys, xs)

    @staticmethod
    def backward(ctx, g):
        img, ys, xs = ctx.saved_tensors
        need = ctx.needs_input_grad
        if img.is_cuda:
            grads = _bwd(img, ys, xs, g.contiguous(), need_img=need[0])
        else:
            grads = crop_taps_backward_reference(img, ys, xs, g, need_img=need[0])
        return tuple(t if n else None for t, n in zip(grads, need))


def stn_crop_taps(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img [B,H,W,C], ys [B,K,ho], xs [B,K,wo] (input pixels) -> glimpses [B,K,ho,wo,C].

    CUDA tensors launch the kernel pair; CPU tensors take the plain version.
    """
    return StnCropTaps.apply(img.contiguous(), ys.contiguous(), xs.contiguous())
