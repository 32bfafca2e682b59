"""STN glimpse crop: the CUDA kernel pair and its plain version.

    glimpse[b,k,p,q,c] = sum_{i,j} wy[b,k,p,i] * img[b,i,j,c] * wx[b,k,q,j]

Replaces the Pallas TPU kernels ``tools/pallas_research/crop_fused.py``
(``_fwd_kernel:33``, ``_bwd_kernel:42``) and
``tools/pallas_research/crop_packed.py`` (``_fwd_kernel:64``,
``_bwd_kernel:80``): the packed one is the same function in the TPU's 8-row
sublane layout, which has no meaning on a GPU, so the one kernel pair in
``csrc/crop.cu`` stands for both and takes any H, W, ho, wo, C and K.

What bounds it on an H100 SXM (B=256, K=16, 48 -> 32 px, C=3, fp32): the
forward moves 107.7 MB (32 us at 3.35 TB/s) and does 3.02 GFLOP of dense
products (45 us at 67 TFLOP/s fp32 without tensor cores); the backward moves
165.2 MB (49 us) and does five products a cell, 7.85 GFLOP (117 us). Both
are bound by operations. The design (csrc/crop.cu): the image stays in
shared memory in its device layout [H][W*C], so the products with wy run
over all channels at once; the forward splits an image's cells over blocks
to fill the card; the backward sums g_img over an image's cells inside one
block, in cell order, so it is deterministic and uses no atomics, and splits
the cells over blocks when the image needs no gradient. Plain fp32 FMAs from
shared memory, dense products although wy and wx rows hold two non-zeros
each; measured times are in PERF.md.

On a CPU tensor the wrapper computes the plain version (``crop_reference``,
``crop_backward_reference``); on a CUDA tensor it launches the kernels or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from split_vae_torch.kernels.build import build as build_library
from split_vae_torch.kernels.build import check_tensor, stream_of

# Launch counts of the forward and backward kernels: each wrapper adds one
# where it launches its kernel, and nowhere else.
fwd_launches = 0
bwd_launches = 0

_lib = None


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------


def crop_reference(img: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """img [B,H,W,C], wy [B,K,ho,H], wx [B,K,wo,W] -> glimpses [B,K,ho,wo,C]."""
    tmp = torch.einsum("bkpi,bijc->bkpjc", wy, img)
    return torch.einsum("bkpjc,bkqj->bkpqc", tmp, wx)


def crop_backward_reference(img, wy, wx, g, need_img: bool = True):
    """(g_img or None, g_wy, g_wx) for the cotangent g [B,K,ho,wo,C], in plain torch."""
    t = torch.einsum("bkpqc,bkqj->bkpjc", g, wx)
    g_img = torch.einsum("bkpi,bkpjc->bijc", wy, t) if need_img else None
    g_wy = torch.einsum("bkpjc,bijc->bkpi", t, img)
    tmp = torch.einsum("bkpi,bijc->bkpjc", wy, img)
    g_wx = torch.einsum("bkpqc,bkpjc->bkqj", g, tmp)
    return g_img, g_wy, g_wx


# --------------------------------------------------------------------------
# Build and bind
# --------------------------------------------------------------------------


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library("crop"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crop_fwd.argtypes = [p] * 4 + [i] * 7 + [p]
        lib.crop_fwd.restype = i
        lib.crop_bwd.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.crop_bwd.restype = i
        lib.crop_error_string.argtypes = [i]
        lib.crop_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _load().crop_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _shapes(img, wy, wx):
    b, h, w, c = img.shape
    k, ho, wo = wy.shape[1], wy.shape[2], wx.shape[2]
    for name, t, shape in (("wy", wy, (b, k, ho, h)), ("wx", wx, (b, k, wo, w))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    return b, k, h, w, ho, wo, c


def _fwd(img, wy, wx):
    global fwd_launches
    for name, t in (("img", img), ("wy", wy), ("wx", wx)):
        check_tensor(t, torch.float32, name)
    b, k, h, w, ho, wo, c = _shapes(img, wy, wx)
    out = torch.empty((b, k, ho, wo, c), device=img.device, dtype=torch.float32)
    err = _load().crop_fwd(img.data_ptr(), wy.data_ptr(), wx.data_ptr(), out.data_ptr(),
                           b, k, h, w, ho, wo, c, stream_of(img))
    _raise_on(err, "crop_fwd")
    fwd_launches += 1
    return out


def _bwd(img, wy, wx, g, need_img: bool = True):
    """The backward kernel: (g_img or None, g_wy, g_wx)."""
    global bwd_launches
    check_tensor(g, torch.float32, "g")
    b, k, h, w, ho, wo, c = _shapes(img, wy, wx)
    if tuple(g.shape) != (b, k, ho, wo, c):
        raise ValueError(f"g: expected shape {(b, k, ho, wo, c)}, got {tuple(g.shape)}")
    g_img = torch.empty_like(img) if need_img else None
    g_wy, g_wx = torch.empty_like(wy), torch.empty_like(wx)
    err = _load().crop_bwd(img.data_ptr(), wy.data_ptr(), wx.data_ptr(), g.data_ptr(),
                           g_img.data_ptr() if need_img else None, g_wy.data_ptr(),
                           g_wx.data_ptr(), b, k, h, w, ho, wo, c, stream_of(img))
    _raise_on(err, "crop_bwd")
    bwd_launches += 1
    return g_img, g_wy, g_wx


class StnCropApply(torch.autograd.Function):
    """The crop with its hand-written backward: kernels on a GPU, plain torch on the CPU."""

    @staticmethod
    def forward(ctx, img, wy, wx):
        ctx.save_for_backward(img, wy, wx)
        return _fwd(img, wy, wx) if img.is_cuda else crop_reference(img, wy, wx)

    @staticmethod
    def backward(ctx, g):
        img, wy, wx = ctx.saved_tensors
        need = ctx.needs_input_grad
        if img.is_cuda:
            grads = _bwd(img, wy, wx, g.contiguous(), need_img=need[0])
        else:
            grads = crop_backward_reference(img, wy, wx, g, need_img=need[0])
        return tuple(t if n else None for t, n in zip(grads, need))


def stn_crop_apply(img: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """img [B,H,W,C], wy [B,K,ho,H], wx [B,K,wo,W] -> glimpses [B,K,ho,wo,C].

    CUDA tensors launch the kernel pair; CPU tensors take the plain version.
    """
    return StnCropApply.apply(img.contiguous(), wy.contiguous(), wx.contiguous())
