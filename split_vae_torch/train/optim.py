"""Optimizer (split_vae_tpu/train/optim.py): per-tensor clipnorm, Adam, skip of non-finite updates.

Written as optax-style transformations, init(params) -> state and
update(grads, state) -> (updates, state), over lists of tensors, so the math
and the state follow optax step for step:

- ``clip_by_per_tensor_norm``: Keras ``clipnorm`` clips each gradient tensor
  by its own L2 norm, g * max_norm / max(||g||, max_norm).
- ``adam``: optax.adam with the Keras epsilon 1e-7.
- ``nan_robust``: skips an update whose gradients or inner updates hold a
  NaN or Inf, leaves the inner state as it was, and counts the skips.

The SPAIR chain is nan_robust(chain(clip 1.0, adam)) (train/loop.py:295-296),
the LGVae chain nan_robust(adam) with no clip (train/loop.py:55,65).
The skip is a select on the device, so a step needs no sync.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

Tensors = List[torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def clip_by_per_tensor_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state):
        norms = torch._foreach_norm(grads)
        return [g * (max_norm / torch.clamp_min(n, max_norm)) for g, n in zip(grads, norms)], state

    return GradientTransformation(init, update)


class AdamState(NamedTuple):
    count: torch.Tensor  # int32
    mu: Tensors
    nu: Tensors


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-7) -> GradientTransformation:
    def init(params):
        return AdamState(torch.zeros((), dtype=torch.int32, device=params[0].device),
                         [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(grads, state):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        t = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
        updates = [-learning_rate * ((m / bc1) / (torch.sqrt(v / bc2) + eps))
                   for m, v in zip(mu, nu)]
        return updates, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


class SkipNonFiniteState(NamedTuple):
    total_notfinite: torch.Tensor  # int32 count of skipped updates
    inner_state: object


def _select(ok: torch.Tensor, new, old):
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    if isinstance(new, (list, tuple)):
        picked = [_select(ok, n, o) for n, o in zip(new, old)]
        return type(new)(*picked) if hasattr(new, "_fields") else type(new)(picked)
    return new


def nan_robust(tx: GradientTransformation) -> GradientTransformation:
    def init(params):
        return SkipNonFiniteState(torch.zeros((), dtype=torch.int32, device=params[0].device),
                                  tx.init(params))

    def update(grads, state):
        inner_updates, inner_state = tx.update(grads, state.inner_state)
        finite = torch.stack([torch.isfinite(u).all() for u in list(grads) + inner_updates]).all()
        updates = [torch.where(finite, u, torch.zeros_like(u)) for u in inner_updates]
        inner = _select(finite, inner_state, state.inner_state)
        count = state.total_notfinite + (~finite).to(torch.int32)
        return updates, SkipNonFiniteState(count, inner)

    return GradientTransformation(init, update)


def spair_optimizer(learning_rate: float) -> GradientTransformation:
    """Keras Adam(lr, clipnorm=1.0) as the JAX package trains SPAIR (train/loop.py:295-296)."""
    return nan_robust(chain(clip_by_per_tensor_norm(1.0), adam(learning_rate)))


def vae_optimizer(learning_rate: float) -> GradientTransformation:
    """Keras Adam(lr) as the JAX package trains LGVae (train/loop.py:55,65)."""
    return nan_robust(adam(learning_rate))


def notfinite_count(opt_state):
    """Total skipped (non-finite) updates of a nan_robust state, else None."""
    return getattr(opt_state, "total_notfinite", None)
