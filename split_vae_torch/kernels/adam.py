"""Adam with the per-tensor clip and the non-finite skip, fused: one step of
``nan_robust([clip_by_per_tensor_norm ->] adam)`` over every leaf of a model
in three CUDA kernels (``csrc/adam.cu``), in place.

The passes: reduce (each chunk's sum of g^2 and whether its g holds a NaN or
an Inf; the bias corrections from the device count), check (each element's
update as it will be committed; the step's verdict on the device) and commit
(p, mu, nu and count where the verdict is clean, else the skip's counter).
The leaves' addresses travel in the launches' arguments, so nothing is
copied to the device for a launch and nothing waits for the device. The
numbers are those of the ``torch._foreach_*`` chain of ``train/optim.py``,
operation by operation (see ``csrc/adam.cu``); that chain is the plain
version the card's tests hold the kernels to.

``leaves`` checks what the kernels take and reads the addresses, on every
call: the state's tensors may be replaced between steps (a checkpoint's
restore, ``train/chains.py::at_count``), so no address is kept. A gradient
that is not contiguous (cuDNN gives a convolution's weight gradient
channels-last) is read through its strides (``Leaves.layouts``): on the
card that kept the optimizer's host time 0.3-0.6 ms a step under a
contiguous copy of those gradients.
"""

from __future__ import annotations

import ctypes
import operator
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from split_vae_torch.core import tracing
from split_vae_torch.kernels.build import build as build_library
from split_vae_torch.kernels.build import check_tensor, f32, stream_of

_lib = None
_DTYPE = operator.attrgetter("dtype")
_SHAPE = operator.attrgetter("shape")
_DEVICE = operator.attrgetter("device")


class Leaves(NamedTuple):
    """What a step's launches take of the leaves: 4n addresses (every p,
    then every g, mu, nu), the n sizes, each g's layout [n, 7] (where g is
    not contiguous, p's shape as 4-D sizes 1..3 and g's strides as 4-D;
    else zeros), and their device."""

    addresses: np.ndarray
    sizes: np.ndarray
    layouts: np.ndarray
    device: torch.device


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library("adam"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.adam_step.argtypes = [p, p, p, i] + [f] * 6 + [p, f, i, p, p, p, i, p, p]
        lib.adam_step.restype = i
        lib.adam_chunks.argtypes = [p, i]
        lib.adam_chunks.restype = ctypes.c_int64
        lib.adam_max_leaves.argtypes = []
        lib.adam_max_leaves.restype = i
        lib.adam_max_strided.argtypes = []
        lib.adam_max_strided.restype = i
        lib.adam_error_string.argtypes = [i]
        lib.adam_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def on_card(params: List[torch.Tensor]) -> bool:
    """Whether a step over these parameters is the kernels': float32 on a
    CUDA device (the first parameter's; ``leaves`` checks every tensor)."""
    return params[0].is_cuda and params[0].dtype == torch.float32


def _describe(name: str, t: torch.Tensor) -> str:
    return (f"{name} {t.dtype} on {t.device}, shape {tuple(t.shape)}, strides {t.stride()}, "
            f"contiguous={t.is_contiguous()}")


def _refuse(params, grads, mu, nu) -> str:
    """Why the kernels cannot take these leaves: the first leaf at fault."""
    if not params:
        return "no leaves"
    if not (len(grads) == len(mu) == len(nu) == len(params)):
        return (f"{len(params)} parameters, {len(grads)} gradients, {len(mu)} first and "
                f"{len(nu)} second moments")
    device = params[0].device
    for i, four in enumerate(zip(params, grads, mu, nu)):
        for name, t in zip(("p", "g", "mu", "nu"), four):
            if (t.dtype != torch.float32 or t.device != device or t.shape != four[0].shape
                    or t.numel() >= 2**31 or not (t.is_contiguous() or name == "g"
                                                  and _strided(t) is not None)):
                return (f"leaf {i}: {_describe(name, t)} (the kernels take float32 on {device}, "
                        f"of p's shape {tuple(four[0].shape)}, under 2^31 elements; p, mu and "
                        f"nu contiguous, g contiguous or at most 4-D with strides >= 0)")
    return "unknown"


def leaves(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
           nu: List[torch.Tensor]) -> Leaves:
    """The leaves as the kernels take them: every tensor float32 on the
    first parameter's device, the four of a leaf of one shape, under 2^31
    elements, p, mu and nu contiguous, g contiguous or at most 4-D with
    strides >= 0 (cuDNN gives a convolution's weight gradient
    channels-last). Raises a ValueError that names the first leaf at fault
    otherwise. Checked with as few calls a tensor as will do: this runs on
    the host every step."""
    n = len(params)
    tensors = [*params, *grads, *mu, *nu]
    shapes = list(map(_SHAPE, tensors))
    ok = (n > 0 and len(tensors) == 4 * n
          and set(map(_DTYPE, tensors)) == {torch.float32}
          and set(map(_DEVICE, tensors)) == {params[0].device}
          and shapes[n:2 * n] == shapes[:n] and shapes[2 * n:3 * n] == shapes[:n]
          and shapes[3 * n:] == shapes[:n])
    sizes = list(map(torch.Tensor.numel, params)) if ok else []
    ok = ok and max(sizes) < 2**31 and all(map(torch.Tensor.is_contiguous, [*params, *mu, *nu]))
    layouts = np.zeros((n, 7), dtype=np.int64)
    for i, contiguous in enumerate(map(torch.Tensor.is_contiguous, grads) if ok else ()):
        if not contiguous:
            layout = _strided(grads[i])
            if layout is None:
                ok = False
                break
            layouts[i] = layout
    if not ok:
        raise ValueError("the fused optimizer cannot take these leaves: "
                         + _refuse(params, grads, mu, nu))
    return Leaves(np.array(list(map(torch.Tensor.data_ptr, tensors)), dtype=np.int64),
                  np.array(sizes, dtype=np.int64), layouts, params[0].device)


def _strided(g: torch.Tensor) -> Optional[List[int]]:
    """A strided g's row of ``Leaves.layouts``, or None where the kernels
    cannot read it."""
    if g.dim() > 4:
        return None
    pad = 4 - g.dim()
    dims, strides = (1,) * pad + tuple(g.shape), (0,) * pad + tuple(g.stride())
    if min(strides) < 0 or sum((d - 1) * s for d, s in zip(dims, strides)) >= 2**31:
        return None
    return [*dims[1:], *strides]


def step_(found: Leaves, count: torch.Tensor, notfinite: torch.Tensor,
          learning_rate: Union[float, torch.Tensor], b1: float, b2: float, eps: float,
          max_norm: Optional[float] = None) -> None:
    """One step in place over ``found`` (from ``leaves``): count and notfinite
    are the 0-d int32 tensors of the state, ``learning_rate`` a float or the
    schedule's 0-d float32 tensor, ``max_norm`` the clip's (None: no clip)."""
    check_tensor(count, torch.int32, "count")
    check_tensor(notfinite, torch.int32, "total_notfinite")
    lr, lr_tensor = learning_rate, None
    if isinstance(learning_rate, torch.Tensor):
        check_tensor(learning_rate, torch.float32, "learning_rate")
        lr, lr_tensor = 0.0, learning_rate
    for name, t in (("count", count), ("total_notfinite", notfinite), ("learning_rate", lr_tensor)):
        if t is not None and (t.numel() != 1 or t.device != found.device):
            raise ValueError(f"{name}: need one element on {found.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    n = len(found.sizes)
    lib = _load()
    blocks = lib.adam_chunks(found.sizes.ctypes.data, n)
    workspace = torch.empty(2 * blocks + 3, dtype=torch.float32, device=found.device)
    launched = ctypes.c_int(0)
    err = lib.adam_step(
        found.addresses.ctypes.data, found.sizes.ctypes.data, found.layouts.ctypes.data, n,
        f32(b1), f32(1 - b1), f32(b2), f32(1 - b2), f32(eps), f32(lr),
        None if lr_tensor is None else lr_tensor.data_ptr(),
        f32(max_norm if max_norm is not None else 0.0), int(max_norm is not None),
        count.data_ptr(), notfinite.data_ptr(), workspace.data_ptr(), blocks,
        stream_of(workspace), ctypes.byref(launched))
    if err != 0:
        raise RuntimeError(f"adam_step: CUDA error {err} ({lib.adam_error_string(err).decode()})")
    tracing.count("optim.fused", launched.value)
