"""SPAIR z_pres count-prior KL (split_vae_tpu/ops/count_prior.py).

A geometric prior over object counts is conditioned on each cell's presence
sample in turn while a per-cell Binary-Concrete KL accumulates
(spair/trainer.py:45-94). CUDA inputs take the kernel pair of
``kernels/count_prior.py``, CPU inputs the loop over cells here, the form
the CPU tests hold to the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from split_vae_torch.kernels import count_prior
from split_vae_torch.ops.distributions import as_like, concrete_binary_sample_kl, safe_log


def z_pres_count_kl(z_pres: torch.Tensor, z_pres_logits: torch.Tensor,
                    z_pres_pre_sigmoid: torch.Tensor, prior_prob, temperature: float) -> torch.Tensor:
    """Count-prior KL for z_pres [B, gh, gw, 1], batch-meaned and summed over cells.

    ``prior_prob`` is the geometric prior's success probability (annealed
    0 -> 0.99 in training): a Python number or a 0-d tensor on the device.
    On the card the inputs launch the kernel pair (one launch each way), which
    takes float32 alone and raises on another dtype; on the CPU
    ``count_kl_loop`` runs.
    """
    inputs = (z_pres, z_pres_logits, z_pres_pre_sigmoid)
    if any(t.is_cuda for t in inputs):
        return torch.mean(count_prior.count_kl_totals(*inputs, prior_prob, temperature))
    return count_kl_loop(*inputs, prior_prob, temperature)


def count_kl_loop(z_pres: torch.Tensor, z_pres_logits: torch.Tensor,
                  z_pres_pre_sigmoid: torch.Tensor, prior_prob, temperature: float) -> torch.Tensor:
    """``z_pres_count_kl`` as a loop over cells of ATen ops, on any device."""
    return torch.mean(count_kl_terms(z_pres, z_pres_logits, z_pres_pre_sigmoid, prior_prob,
                                     temperature)[0])


def count_kl_terms(z_pres: torch.Tensor, z_pres_logits: torch.Tensor,
                   z_pres_pre_sigmoid: torch.Tensor, prior_prob, temperature: float
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The loop: each image's KL summed over its cells [B], and each cell's
    prior log-odds [B, 1] in the cells' order (the log-odds the kernel pair's
    backward reads)."""
    b = z_pres.shape[0]
    k = z_pres[0].numel()
    dtype, device = z_pres.dtype, z_pres.device

    support = torch.arange(k + 1, dtype=dtype, device=device)
    count_prior_prob = 1.0 - as_like(prior_prob, z_pres)
    dist = (1.0 - count_prior_prob) * torch.pow(count_prior_prob, support)
    dist = dist / torch.clamp_min(torch.sum(dist), 1e-6)
    count_distribution = dist[None, :].expand(b, k + 1)
    count_so_far = torch.zeros((b, 1), dtype=dtype, device=device)

    # Cells in the reference's row-major (h, w) order.
    pre = z_pres_pre_sigmoid.reshape(b, k)
    logits = z_pres_logits.reshape(b, k)
    pres = z_pres.reshape(b, k)

    total = torch.zeros((b,), dtype=dtype, device=device)
    log_odds = []
    for i in range(k):
        p_z_given_cz = torch.clamp_min(support[None, :] - count_so_far, 0.0) / (k - i)
        p_z = torch.sum(count_distribution * p_z_given_cz, dim=1, keepdim=True)
        prior_log_odds = safe_log(p_z) - safe_log(1.0 - p_z)
        obj_kl = concrete_binary_sample_kl(pre[:, i:i + 1], prior_log_odds, temperature,
                                           logits[:, i:i + 1], temperature)
        sample = (pres[:, i:i + 1] > 0.5).to(dtype)
        mult = sample * p_z_given_cz + (1.0 - sample) * (1.0 - p_z_given_cz)
        count_distribution = mult * count_distribution
        normalizer = torch.clamp_min(torch.sum(count_distribution, dim=1, keepdim=True), 1e-6)
        count_distribution = count_distribution / normalizer
        count_so_far = count_so_far + sample
        total = total + obj_kl[:, 0]
        log_odds.append(prior_log_odds)
    return total, log_odds
