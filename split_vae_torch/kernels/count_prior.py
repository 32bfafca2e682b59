"""The SPAIR z_pres count-prior KL as a CUDA kernel pair.

``ops/count_prior.py::count_kl_loop`` runs the recurrence as ~20 ATen ops a
cell in each direction; on the card each is a launch of microseconds of
work on [B, K+1] or [B, 1], ~1,400 a train step at B=256, K=16. The pair in
``csrc/count_prior.cu`` takes the whole of it: the forward a warp an image
over the K cells in row-major order, writing each image's total and each
cell's prior log-odds; the backward a thread a cell, the closed-form
gradients of the cell's Binary-Concrete KL with respect to the pre-sigmoid
sample and the logits (nothing else carries a gradient: z_pres enters only
through its > 0.5 threshold, the prior probability is an anneal). The batch
mean stays a ``torch.mean`` over the totals. It replaces no TPU kernel: the
JAX package writes the recurrence as a ``lax.scan``.

``CountPriorKL`` takes CUDA float32 tensors alone and raises on anything
else; ``ops/count_prior.py::z_pres_count_kl`` sends every CUDA input here
and runs the loop on the CPU. ``count_kl_backward_reference`` is the
backward kernel's closed form in plain PyTorch, which the CPU tests hold
against the loop's autograd and the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

from split_vae_torch.core import tracing
from split_vae_torch.kernels.build import build as build_library
from split_vae_torch.kernels.build import check_tensor, f32, stream_of

EPS = 1e-8  # safe_log's and concrete_binary_sample_kl's

_lib = None

Prior = Union[float, torch.Tensor]


# --------------------------------------------------------------------------
# The backward's closed form in plain PyTorch
# --------------------------------------------------------------------------


def count_kl_backward_reference(logits: torch.Tensor, pre: torch.Tensor,
                                log_odds: torch.Tensor, temperature: float,
                                g_totals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g_logits, g_pre) [B, K] for the cotangent g_totals [B]: the backward
    kernel's closed form, in autograd's expression order through the loop."""
    g = g_totals[:, None].expand_as(pre)
    yt = pre * temperature
    e_q, e_p = torch.exp(-yt + logits), torch.exp(-yt + log_odds)
    m_q = ((-g) * 2.0) / ((e_q + 1.0) + EPS) * e_q
    m_p = (g * 2.0) / ((e_p + 1.0) + EPS) * e_p
    return g + m_q, (g + (-m_p)) * temperature + ((-g) + (-m_q)) * temperature


# --------------------------------------------------------------------------
# Build and bind
# --------------------------------------------------------------------------


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library("count_prior"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.count_prior_fwd.argtypes = [p] * 4 + [f] * 3 + [i] * 2 + [p] * 3
        lib.count_prior_fwd.restype = i
        lib.count_prior_bwd.argtypes = [p] * 4 + [f] + [i] * 2 + [p] * 3
        lib.count_prior_bwd.restype = i
        lib.count_prior_error_string.argtypes = [i]
        lib.count_prior_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _load().count_prior_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _prior(prior_prob: Prior, like: torch.Tensor) -> torch.Tensor:
    """The prior probability as a 0-d tensor in ``like``'s dtype on its device."""
    if isinstance(prior_prob, torch.Tensor):
        return prior_prob.to(dtype=like.dtype, device=like.device).reshape(())
    return torch.full((), prior_prob, dtype=like.dtype, device=like.device)


def _fwd(pres, logits, pre, prior_prob: Prior, temperature: float):
    """The forward kernel: (totals [B], log_odds [B, K])."""
    for name, t in (("z_pres", pres), ("z_pres_logits", logits), ("z_pres_pre_sigmoid", pre)):
        check_tensor(t, torch.float32, name)
    b, k = pre.shape
    lib = _load()
    prior = _prior(prior_prob, pre) if isinstance(prior_prob, torch.Tensor) else None
    totals = torch.empty((b,), dtype=torch.float32, device=pre.device)
    log_odds = torch.empty((b, k), dtype=torch.float32, device=pre.device)
    err = lib.count_prior_fwd(pres.data_ptr(), logits.data_ptr(), pre.data_ptr(),
                              None if prior is None else prior.data_ptr(),
                              0.0 if prior is not None else f32(prior_prob), f32(temperature),
                              f32(math.log(temperature + EPS)), b, k, totals.data_ptr(),
                              log_odds.data_ptr(), stream_of(pre))
    _raise_on(err, "count_prior_fwd")
    if b:
        tracing.count("count_prior.fwd")
    return totals, log_odds


def _bwd(logits, pre, log_odds, g_totals, temperature: float):
    """The backward kernel: (g_logits, g_pre) [B, K]."""
    for name, t in (("z_pres_logits", logits), ("z_pres_pre_sigmoid", pre),
                    ("log_odds", log_odds), ("g", g_totals)):
        check_tensor(t, torch.float32, name)
    b, k = pre.shape
    if tuple(g_totals.shape) != (b,):
        raise ValueError(f"g: expected shape {(b,)}, got {tuple(g_totals.shape)}")
    g_logits, g_pre = torch.empty_like(logits), torch.empty_like(pre)
    err = _load().count_prior_bwd(logits.data_ptr(), pre.data_ptr(), log_odds.data_ptr(),
                                  g_totals.data_ptr(), f32(temperature), b, k,
                                  g_logits.data_ptr(), g_pre.data_ptr(), stream_of(pre))
    _raise_on(err, "count_prior_bwd")
    if b * k:
        tracing.count("count_prior.bwd")
    return g_logits, g_pre


class CountPriorKL(torch.autograd.Function):
    """Each image's count-prior KL over CUDA float32 (pres, logits, pre)
    [B, K] by the kernel pair. ``prior_prob`` is a Python number or a 0-d
    tensor; it and ``pres`` get no gradient."""

    @staticmethod
    def forward(ctx, pres, logits, pre, prior_prob, temperature):
        totals, log_odds = _fwd(pres, logits, pre, prior_prob, temperature)
        ctx.save_for_backward(logits, pre, log_odds)
        ctx.temperature = temperature
        ctx.mark_non_differentiable(log_odds)
        return totals, log_odds

    @staticmethod
    def backward(ctx, g_totals, _g_log_odds):
        logits, pre, log_odds = ctx.saved_tensors
        g_logits, g_pre = _bwd(logits, pre, log_odds, g_totals.contiguous(), ctx.temperature)
        need = ctx.needs_input_grad
        return None, g_logits if need[1] else None, g_pre if need[2] else None, None, None


def count_kl_totals(z_pres: torch.Tensor, z_pres_logits: torch.Tensor,
                    z_pres_pre_sigmoid: torch.Tensor, prior_prob: Prior,
                    temperature: float) -> torch.Tensor:
    """z_pres, z_pres_logits, z_pres_pre_sigmoid [B, gh, gw, 1] -> each
    image's count-prior KL summed over its cells [B].

    The tensors are CUDA float32; anything else raises. ``prior_prob`` is the
    geometric prior's success probability: a Python number or a 0-d tensor
    (read on the card where it lies, so a CUDA graph's replay reads the
    anneal it recomputed)."""
    shape = tuple(z_pres_pre_sigmoid.shape)
    for name, t in (("z_pres", z_pres), ("z_pres_logits", z_pres_logits)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if isinstance(prior_prob, torch.Tensor) and prior_prob.numel() != 1:
        raise ValueError(f"prior_prob: need one element, got shape {tuple(prior_prob.shape)}")
    b = shape[0]
    flat = [t.reshape(b, -1).contiguous() for t in (z_pres, z_pres_logits, z_pres_pre_sigmoid)]
    return CountPriorKL.apply(*flat, prior_prob, temperature)[0]
