"""Training state (split_vae_tpu/core/state.py): step, parameters, optimizer state, generator.

The model holds the parameters; the update writes them in place. A
``torch.Generator`` on the model's device takes the place of the PRNG key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import torch
from torch import nn

from split_vae_torch.train.optim import GradientTransformation


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: Any
    tx: GradientTransformation
    generator: torch.Generator

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    def apply_gradients(self, grads: List[torch.Tensor]) -> "TrainState":
        params = self.params
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(list(grads), self.opt_state)
            torch._foreach_add_(params, updates)
        self.step += 1
        return self


def tree_tensors(tree) -> List[torch.Tensor]:
    """The tensors of an optimizer state (NamedTuples, tuples, lists), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_tensors(sub)]
    return []


def create_train_state(model: nn.Module, tx: GradientTransformation, seed: int = 0) -> TrainState:
    """Wraps a built model; the generator lives on the model's device."""
    params = list(model.parameters())
    generator = torch.Generator(device=params[0].device).manual_seed(seed)
    return TrainState(step=0, model=model, opt_state=tx.init(params), tx=tx,
                      generator=generator)
