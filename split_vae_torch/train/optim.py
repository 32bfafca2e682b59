"""Optimizer (split_vae_tpu/train/optim.py): per-tensor clipnorm, Adam and
AMSGrad, skip of non-finite updates.

Written as optax-style transformations, init(params) -> state and
update(grads, state) -> (updates, state), over lists of tensors, so the math
and the state follow optax step for step:

- ``clip_by_per_tensor_norm``: Keras ``clipnorm`` clips each gradient tensor
  by its own L2 norm, g * max_norm / max(||g||, max_norm). The norm is
  sqrt(sum(g * g)) in float32 as the JAX package takes it, and summed as
  closely as XLA sums it. On the CPU torch's norm kernel misses by an error
  that grows with the tensor (2.3e-5 of the norm at 1.8M elements, 1.8e-4 at
  the 7.1M of config #5's background decoder), so there the norm is taken
  from ``torch.sum``; on the card ``_foreach_norm`` takes every tensor's in
  one launch.
- ``adam``: optax.adam with the Keras epsilon 1e-7; the learning rate is a
  float or a schedule of the count, read at the count before the update as
  optax's ``scale_by_schedule`` reads it. ``amsgrad=True`` is
  optax.amsgrad: the running maximum of the *bias-corrected* second moment,
  nu_max = max(nu_max, nu / (1 - b2^t)), and update mu_hat / (sqrt(nu_max) +
  eps). ``torch.optim.Adam(amsgrad=True)`` keeps the maximum of the raw
  moment and corrects it afterwards, which gives other numbers.
- ``nan_robust``: skips an update whose gradients or inner updates hold a
  NaN or Inf, leaves the inner state as it was (the count too, so a schedule
  does not advance), and counts the skips.

The SPAIR chain is nan_robust(chain(clip 1.0, adam)) (train/loop.py:295-296),
the LGVae chain nan_robust(adam) with no clip (train/loop.py:55,65), the GM
chain nan_robust(adam(gm_lr_schedule)) (train/loop.py:56-62), the probe
classifier's adam(1e-4, amsgrad=True) (train/probes.py:171).
The skip is a select on the device, so a step needs no sync.

Each transformation runs as ``torch._foreach_*`` calls over the whole list
(a host call an operation, where a loop over the tensors made one an
operation and tensor), in the order of the per-tensor formulas, so its
numbers are theirs bit for bit (``tests/test_torch_optim_lists.py``); the
non-finite select stays one ``torch.where`` a tensor.

Tensor parallelism (``parallel/mesh.py::model_reduce``): where a gradient is
this rank's block of a parameter's rows, the clip takes the parameter's norm
(the blocks' squared norms summed over the model group) and the skip decides
on the whole group's gradients (the finite flag AND-reduced over it), so the
ranks of a group clip and skip alike. Without a ``ModelReduce`` the chains do
no collective.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Union

import torch

from split_vae_torch.train.schedules import gm_lr_schedule

Tensors = List[torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class ModelReduce(NamedTuple):
    """A model group's reductions: ``norms(grads, norms)`` gives each
    gradient's full L2 norm from this rank's ``norms`` of ``grads``;
    ``all(flag)`` the AND of a 0-d bool over the group."""

    norms: Callable
    all: Callable


def clip_by_per_tensor_norm(max_norm: float,
                            model_reduce: Optional[ModelReduce] = None) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state):
        if grads and grads[0].is_cuda:
            norms = torch._foreach_norm(grads)
        else:
            norms = [torch.sqrt(torch.sum(g * g)) for g in grads]
        if model_reduce is not None:
            norms = model_reduce.norms(grads, norms)
        scales = max_norm / torch.clamp_min(torch.stack(norms), max_norm)
        return list(torch._foreach_mul(grads, list(scales.unbind()))), state

    return GradientTransformation(init, update)


class AdamState(NamedTuple):
    count: torch.Tensor  # int32
    mu: Tensors
    nu: Tensors


class AmsgradState(NamedTuple):
    count: torch.Tensor  # int32
    mu: Tensors
    nu: Tensors
    nu_max: Tensors


def adam(learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]],
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7,
         amsgrad: bool = False) -> GradientTransformation:
    def init(params):
        count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        if amsgrad:
            return AmsgradState(count, mu, nu, [torch.zeros_like(p) for p in params])
        return AdamState(count, mu, nu)

    def update(grads, state):
        lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
        mu = list(torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                     torch._foreach_mul(state.mu, b1)))
        nu = list(torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                                     torch._foreach_mul(state.nu, b2)))
        count = state.count + 1
        t = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
        if amsgrad:
            nu_max = list(torch._foreach_maximum(state.nu_max, torch._foreach_div(nu, bc2)))
            denom = torch._foreach_sqrt(nu_max)
        else:
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, eps)
        updates = list(torch._foreach_div(torch._foreach_div(mu, bc1), denom))
        torch._foreach_mul_(updates, -lr)
        if amsgrad:
            return updates, AmsgradState(count, mu, nu, nu_max)
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


def nan_robust(tx: GradientTransformation,
               model_reduce: Optional[ModelReduce] = None) -> GradientTransformation:
    def init(params):
        return SkipNonFiniteState(torch.zeros((), dtype=torch.int32, device=params[0].device),
                                  tx.init(params))

    def update(grads, state):
        inner_updates, inner_state = tx.update(grads, state.inner_state)
        # The largest |x| of a tensor is finite exactly when every element is
        # (a NaN propagates through the max).
        peaks = torch._foreach_norm(list(grads) + inner_updates, ord=float("inf"))
        finite = torch.isfinite(torch.stack(peaks)).all()
        if model_reduce is not None:
            finite = model_reduce.all(finite)
        updates = [torch.where(finite, u, 0.0) for u in inner_updates]
        inner = _select(finite, inner_state, state.inner_state)
        count = state.total_notfinite + (~finite).to(torch.int32)
        return updates, SkipNonFiniteState(count, inner)

    return GradientTransformation(init, update)


def spair_optimizer(learning_rate: float,
                    model_reduce: Optional[ModelReduce] = None) -> GradientTransformation:
    """Keras Adam(lr, clipnorm=1.0) as the JAX package trains SPAIR (train/loop.py:295-296)."""
    return nan_robust(chain(clip_by_per_tensor_norm(1.0, model_reduce), adam(learning_rate)),
                      model_reduce)


def vae_optimizer(learning_rate: float,
                  model_reduce: Optional[ModelReduce] = None) -> GradientTransformation:
    """Keras Adam(lr) as the JAX package trains LGVae (train/loop.py:55,65)."""
    return nan_robust(adam(learning_rate), model_reduce)


def gm_optimizer(learning_rate: float,
                 model_reduce: Optional[ModelReduce] = None) -> GradientTransformation:
    """Keras Adam with the staircase decay, as the JAX package trains LGGMVae
    and GMVae (train/loop.py:56-62)."""
    return nan_robust(adam(gm_lr_schedule(learning_rate)), model_reduce)


def classifier_optimizer() -> GradientTransformation:
    """Keras Adam(amsgrad=True) at 1e-4 of the probe classifier (train/probes.py:171)."""
    return adam(1e-4, amsgrad=True)


def notfinite_count(opt_state):
    """Total skipped (non-finite) updates of a nan_robust state, else None."""
    return getattr(opt_state, "total_notfinite", None)
