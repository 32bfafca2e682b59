"""Chained train steps held against another run of the same steps.

``tests/test_torch_trajectory.py`` holds the port's chain against the JAX
package's on the CPU, and ``chip_smoke.py``'s P16 the card's chain against
the CPU's. Both use these pieces: an optimizer state started at a count, its
Adam moments, the train steps in float64, and the largest gaps between two
chains (each step's metrics, relative; each tensor, in its L2 norm).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Mapping, Tuple

import torch


def at_count(opt_state, count: int, full_like: Callable):
    """``opt_state`` (NamedTuples and tuples: the port's or optax's) with
    every ``count`` field ``c`` replaced by ``full_like(c, count)``."""
    if hasattr(opt_state, "_fields"):
        return type(opt_state)(*[
            full_like(v, count) if f == "count" else at_count(v, count, full_like)
            for f, v in zip(opt_state._fields, opt_state)])
    if isinstance(opt_state, (tuple, list)):
        return type(opt_state)(at_count(v, count, full_like) for v in opt_state)
    return opt_state


def adam_moments(opt_state):
    """The (mu, nu) of the Adam state inside ``opt_state``, or None."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu
    for sub in opt_state if isinstance(opt_state, (tuple, list)) else ():
        found = adam_moments(sub)
        if found is not None:
            return found
    return None


@contextlib.contextmanager
def float64_steps():
    """The train steps of ``train/steps.py`` in float64: their normalized
    batch and their noise cast up (a float64 model then computes in float64,
    as the JAX package's flax layers do under float64)."""
    from split_vae_torch.core.noise import Noise
    from split_vae_torch.train import steps

    normalize = steps.normalize_images
    steps.normalize_images = lambda batch, mode: normalize(batch, mode).double()
    steps.Noise = lambda *a, **kw: Noise(*a, **{**kw, "dtype": torch.float64})
    try:
        yield
    finally:
        steps.normalize_images, steps.Noise = normalize, Noise


def metric_gap(want: List[Mapping[str, float]],
               got: List[Mapping[str, float]]) -> Tuple[float, str]:
    """The largest |got - want| / |want| of any metric at any step of two
    chains, and where ("step <n> <metric>", n from 1)."""
    worst = (0.0, "every step")
    for i, (w, g) in enumerate(zip(want, got)):
        if sorted(g) != sorted(w):
            raise ValueError(f"step {i + 1}: metrics {sorted(g)} against {sorted(w)}")
        for k in w:
            gap = abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) if g[k] != w[k] else 0.0
            worst = max(worst, (gap, f"step {i + 1} {k}"), key=lambda x: x[0])
    return worst


def tensor_gap(want: Mapping[str, torch.Tensor],
               got: Mapping[str, torch.Tensor]) -> Tuple[float, str]:
    """The largest ||got - want|| / ||want|| over the named tensors of two
    chains (in float64), and the tensor's name."""
    if sorted(got) != sorted(want):
        raise ValueError("the chains hold different tensors")
    worst = (0.0, "every tensor")
    for name in want:
        w = want[name].detach().double()
        g = got[name].detach().double()
        gap = float((g - w).norm() / w.norm().clamp_min(1e-30)) if not torch.equal(g, w) else 0.0
        worst = max(worst, (gap, name), key=lambda x: x[0])
    return worst
