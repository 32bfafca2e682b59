"""Schedules of the step counter (split_vae_tpu/train/schedules.py), in f32.

The SPAIR anneals take the step as a Python number, and give a host float,
or as a 0-d float32 tensor on the device (``core/noise.py::Noise.step``), and
give a 0-d tensor there: the same float32 operations in the same order, so
the same bits, with nothing read from or copied to the host (the train step
runs as a CUDA graph, which must not bake in the step it was captured at).
``gm_lr_schedule`` is a function of the optimizer's count tensor and stays on
its device: reading it costs the step no sync.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

Step = Union[int, float, torch.Tensor]


def gm_lr_schedule(base_lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """ExponentialDecay(decay_steps=1e6, rate=0.4, staircase=True) of the GM
    models (vae/main.py:67-72): base_lr * 0.4^floor(count / 1e6), an f32
    tensor on the count's device."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return base_lr * torch.pow(0.4, torch.floor(count.to(torch.float32) / 1_000_000.0))

    return schedule


def _over(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d in float32 by a divisor tensor: CUDA turns a division by a
    Python number into a product by its reciprocal, which may miss the
    quotient by a bit."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def z_pres_prior_prob(step: Step, z_pres_anneal_step: float):
    """0 -> 0.99 linear anneal (spair/trainer.py:150)."""
    if isinstance(step, torch.Tensor):
        return 0.99 * torch.clamp_max(_over(step + 1.0, z_pres_anneal_step), 1.0)
    f = np.float32
    return float(f(0.99) * min(f(1.0), (f(step) + f(1.0)) / f(z_pres_anneal_step)))


def z_zoom_prior_mean(step: Step, prior_z_zoom: float, prior_z_zoom_start: float,
                      z_pres_anneal_step: float):
    """prior_z_zoom_start -> prior_z_zoom anneal (spair/trainer.py:153)."""
    if isinstance(step, torch.Tensor):
        frac = torch.clamp_max(_over(step + 1.0, z_pres_anneal_step), 1.0)
        return prior_z_zoom + prior_z_zoom_start * (1.0 - frac)
    f = np.float32
    frac = min((f(step) + f(1.0)) / f(z_pres_anneal_step), f(1.0))
    return float(f(prior_z_zoom) + f(prior_z_zoom_start) * (f(1.0) - frac))


def beta_warmup(step: Step, beta: float, anneal_until: float):
    """min(beta, beta * (step+1)/anneal_until) (spair/trainer.py:165)."""
    if isinstance(step, torch.Tensor):
        return torch.clamp_max(_over(beta * (step + 1.0), anneal_until), beta)
    f = np.float32
    return float(min(f(beta), f(beta) * (f(step) + f(1.0)) / f(anneal_until)))
