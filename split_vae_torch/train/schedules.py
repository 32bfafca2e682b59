"""Schedules of the step counter (split_vae_tpu/train/schedules.py), in f32.

The SPAIR anneals are host floats of the loop's step. ``gm_lr_schedule`` is a
function of the optimizer's count tensor and stays on its device: reading it
costs the step no sync.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def gm_lr_schedule(base_lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """ExponentialDecay(decay_steps=1e6, rate=0.4, staircase=True) of the GM
    models (vae/main.py:67-72): base_lr * 0.4^floor(count / 1e6), an f32
    tensor on the count's device."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return base_lr * torch.pow(0.4, torch.floor(count.to(torch.float32) / 1_000_000.0))

    return schedule


def z_pres_prior_prob(step, z_pres_anneal_step: float) -> float:
    """0 -> 0.99 linear anneal (spair/trainer.py:150)."""
    f = np.float32
    return float(f(0.99) * min(f(1.0), (f(step) + f(1.0)) / f(z_pres_anneal_step)))


def z_zoom_prior_mean(step, prior_z_zoom: float, prior_z_zoom_start: float,
                      z_pres_anneal_step: float) -> float:
    """prior_z_zoom_start -> prior_z_zoom anneal (spair/trainer.py:153)."""
    f = np.float32
    frac = min((f(step) + f(1.0)) / f(z_pres_anneal_step), f(1.0))
    return float(f(prior_z_zoom) + f(prior_z_zoom_start) * (f(1.0) - frac))


def beta_warmup(step, beta: float, anneal_until: float) -> float:
    """min(beta, beta * (step+1)/anneal_until) (spair/trainer.py:165)."""
    f = np.float32
    return float(min(f(beta), f(beta) * (f(step) + f(1.0)) / f(anneal_until)))
