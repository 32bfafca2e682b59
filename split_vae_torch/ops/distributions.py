"""Distribution and loss primitives (split_vae_tpu/ops/distributions.py).

Reductions keep the reference convention: mean over batch, sum over the rest.
Stochastic ops take their noise as an optional tensor and otherwise draw from
the ``torch.Generator`` they are handed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


def reparameterize(mean: torch.Tensor, sigma: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """z = mean + sigma * eps, eps ~ N(0, 1); ``sigma`` is a standard deviation."""
    if eps is None:
        eps = torch.randn(sigma.shape, generator=generator, device=sigma.device,
                          dtype=sigma.dtype)
    return mean + sigma * eps


def _sum_over_nonbatch(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.reshape(x.shape[0], -1), dim=1)


def mean_sum(x: torch.Tensor) -> torch.Tensor:
    """Mean over the batch dim, sum over everything else."""
    return torch.mean(_sum_over_nonbatch(x))


class _SafeLog(torch.autograd.Function):
    """log(value + eps), NaN/Inf replaced; derivative 1/(value + eps), zero on
    the replaced branch and wherever it is not finite (_safe_log_jvp)."""

    @staticmethod
    def forward(ctx, value, replacement_value, eps):
        log_value = torch.log(value + eps)
        bad = ~torch.isfinite(log_value)
        ctx.save_for_backward(value, bad)
        ctx.eps = eps
        return torch.where(bad, torch.full_like(log_value, replacement_value), log_value)

    @staticmethod
    def backward(ctx, g):
        value, bad = ctx.saved_tensors
        deriv = 1.0 / (value + ctx.eps)
        deriv = torch.where(bad | ~torch.isfinite(deriv), torch.zeros_like(deriv), deriv)
        return deriv * g, None, None


def safe_log(value: torch.Tensor, replacement_value: float = -100.0,
             eps: float = 1e-8) -> torch.Tensor:
    """log(value + 1e-8) with NaN/Inf replaced by -100 (spair/trainer.py:97-101)."""
    return _SafeLog.apply(value, replacement_value, eps)


def as_like(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s dtype on its device: a tensor as it is (cast where
    it is not), a Python number by a fill kernel, which copies nothing from
    the host and so leaves a train step free of syncs."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=like.dtype, device=like.device)
    return torch.full((), x, dtype=like.dtype, device=like.device)


_CONSTANT_LOGS: Dict[tuple, torch.Tensor] = {}


def _safe_log_of(x, like: torch.Tensor) -> torch.Tensor:
    """safe_log(x): of a tensor in autograd; of a Python number computed on
    ``like``'s device once a dtype and device and kept (a constant needs no
    gradient). Nothing is kept while a CUDA graph is being captured, whose
    memory the graph owns."""
    if isinstance(x, torch.Tensor):
        return safe_log(x)
    key = (x, like.dtype, like.device)
    got = _CONSTANT_LOGS.get(key)
    if got is None:
        got = safe_log(as_like(x, like)).detach()
        if not (like.is_cuda and torch.cuda.is_current_stream_capturing()):
            _CONSTANT_LOGS[key] = got
    return got


def gaussian_kl(mean: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """KL(N(mean, sigma^2) || N(0, 1)), summed over non-batch dims, batch-meaned,
    through log-var = log(sigma^2) with a plain log (vae/trainer.py:11-15)."""
    log_var = torch.log(torch.square(sigma))
    kl = -0.5 * (1.0 + log_var - torch.square(mean) - torch.exp(log_var))
    return torch.mean(_sum_over_nonbatch(kl))


def gaussian_kl_two(mean1: torch.Tensor, sig1: torch.Tensor, mean2, sig2) -> torch.Tensor:
    """KL(N(mean1, sig1^2) || N(mean2, sig2^2)) with plain logs (vae/trainer.py:17-18)."""
    mean2 = as_like(mean2, mean1)
    sig2 = as_like(sig2, sig1)
    kl = (torch.log(sig2) - torch.log(sig1)
          + (torch.square(sig1) + torch.square(mean1 - mean2)) / (2.0 * torch.square(sig2))
          - 0.5)
    kl = torch.broadcast_to(kl, torch.broadcast_shapes(kl.shape, mean1.shape))
    return torch.mean(_sum_over_nonbatch(kl))


def discretized_logistic_nll(x: torch.Tensor, mean: torch.Tensor,
                             log_scales: torch.Tensor) -> torch.Tensor:
    """Elementwise negative log-likelihood of a discretized logistic.

    Pixel-CNN binning over 1/255-wide intervals with the reference's edges
    (vae/trainer.py:21-38): the CDF difference in the bulk, one-sided CDFs at
    x < -0.999 and x > 0.999, and the density at the bin's centre where the
    CDF difference falls to 1e-5 or below. Every branch is evaluated and one
    selected, so each is written to keep a finite gradient where it is not
    taken: the log's argument is floored at 1e-12 and the one-sided forms go
    through softplus.
    """
    centered = x - mean
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / 255.0)
    min_in = inv_stdv * (centered - 1.0 / 255.0)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)

    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)

    log_prob = torch.where(
        x < -0.999,
        log_cdf_plus,
        torch.where(
            x > 0.999,
            log_one_minus_cdf_min,
            torch.where(
                cdf_delta > 1e-5,
                torch.log(torch.clamp_min(cdf_delta, 1e-12)),
                log_pdf_mid - math.log(127.5),
            ),
        ),
    )
    return -log_prob


def categorical_kl_uniform(y_logits: torch.Tensor, num_classes: int,
                           eps: float = 1e-8) -> torch.Tensor:
    """KL(softmax(y_logits) || Uniform(num_classes)), batch-meaned
    (vae/trainer.py:160-161: sum py * (log(py + 1e-8) - log(1/K)))."""
    py = torch.softmax(y_logits, dim=-1)
    kl = torch.sum(py * (torch.log(py + eps) - math.log(1.0 / num_classes)), dim=-1)
    return torch.mean(kl)


def gumbel_softmax(logits: torch.Tensor, tau: float, u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gumbel-softmax sample softmax((logits + G)/tau), G = -log(-log U);
    ``u`` are the uniforms."""
    if u is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device,
                       dtype=logits.dtype)
    g = -torch.log(-torch.log(u))
    return torch.softmax((logits + g) / tau, dim=-1)


def gaussian_kl_safe(mean: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """KL(N(mean, sigma^2) || N(0, 1)) with safe_log, batch-meaned."""
    log_var = safe_log(torch.square(sigma))
    kl = -0.5 * (1.0 + log_var - torch.square(mean) - torch.exp(log_var))
    return torch.mean(_sum_over_nonbatch(kl))


def gaussian_kl_two_safe(mean1: torch.Tensor, sig1: torch.Tensor, mean2, sig2) -> torch.Tensor:
    """KL(N(mean1, sig1^2) || N(mean2, sig2^2)) with safe logs, batch-meaned."""
    log_sig2 = _safe_log_of(sig2, sig1)
    mean2 = as_like(mean2, mean1)
    sig2 = as_like(sig2, sig1)
    kl = (log_sig2 - safe_log(sig1)
          + (torch.square(sig1) + torch.square(mean1 - mean2)) / (2.0 * torch.square(sig2))
          - 0.5)
    kl = torch.broadcast_to(kl, torch.broadcast_shapes(kl.shape, mean1.shape))
    return torch.mean(_sum_over_nonbatch(kl))


def concrete_binary_pre_sigmoid_sample(log_odds: torch.Tensor, temperature: float,
                                       u: Optional[torch.Tensor] = None,
                                       generator: Optional[torch.Generator] = None,
                                       eps: float = 1e-8) -> torch.Tensor:
    """Binary-Concrete pre-sigmoid sample (log_odds + logistic noise)/temperature;
    ``u`` are the uniforms of the logistic noise."""
    if u is None:
        u = torch.rand(log_odds.shape, generator=generator, device=log_odds.device,
                       dtype=log_odds.dtype)
    noise = torch.log(u + eps) - torch.log(1.0 - u + eps)
    return (log_odds + noise) / temperature


def concrete_binary_sample_kl(pre_sigmoid_sample, prior_log_odds, prior_temperature,
                              posterior_log_odds, posterior_temperature,
                              eps: float = 1e-8) -> torch.Tensor:
    """Elementwise Binary-Concrete KL estimate log q(y) - log p(y) at the sample."""
    y = pre_sigmoid_sample
    y_prior = y * prior_temperature
    log_prior = (math.log(prior_temperature + eps) - y_prior + prior_log_odds
                 - 2.0 * torch.log(1.0 + torch.exp(-y_prior + prior_log_odds) + eps))
    y_post = y * posterior_temperature
    log_posterior = (math.log(posterior_temperature + eps) - y_post + posterior_log_odds
                     - 2.0 * torch.log(1.0 + torch.exp(-y_post + posterior_log_odds) + eps))
    return log_posterior - log_prior


def bernoulli_xent(label: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Elementwise Bernoulli cross-entropy with safe logs."""
    return -(label * safe_log(pred) + (1.0 - label) * safe_log(1.0 - pred))
