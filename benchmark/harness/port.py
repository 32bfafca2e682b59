"""The program under test: the PyTorch port's training step, its loader and
its running metrics, built for one configuration. The only module of the
benchmark that imports the port (``split_vae_torch``).

A window step is what ``train/loop.py::_train`` runs between evals:
``next()`` on ``data/loader.py::device_resident_batches``, the train step of
``train/steps.py``, ``core/metrics.py::MeanMetrics.update``, and the
metrics' drain every ``log_every`` steps.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List

import numpy as np
import torch


@dataclass
class Program:
    config: Any
    state: Any
    step: Any          # train_step(state, batch, replay=None) -> (state, metrics)
    batches: Iterator
    metrics: Any       # MeanMetrics
    names: List[str]   # the parameters' names, in the state's order

    def window_step(self) -> None:
        """One step of the training loop's body."""
        self.state, m = self.step(self.state, next(self.batches))
        self.metrics.update(m)
        every = self.config.log_every
        if every and self.state.step % every == 0:
            self.metrics.result()

    def adam_state(self):
        """The optimizer's Adam state (``mu``, ``nu``, ``count``)."""
        found = _find(self.state.opt_state, lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
        if found is None:
            raise RuntimeError("no Adam state in the optimizer's state")
        return found

    def load(self, weights: Dict[str, torch.Tensor]) -> None:
        """Copies ``weights`` into the parameters, by name."""
        params = dict(self.state.model.named_parameters())
        if set(params) != set(weights):
            raise ValueError(f"the port's parameters differ from the weights' names: "
                             f"{sorted(set(params) ^ set(weights))[:6]}")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(weights[name])

    def skipped(self) -> int:
        """Updates skipped as non-finite so far."""
        return int(self.state.opt_state.total_notfinite)


def _find(tree, pred):
    if pred(tree):
        return tree
    if isinstance(tree, (list, tuple)):
        for sub in tree:
            got = _find(sub, pred)
            if got is not None:
                return got
    return None


def port_config(cell):
    """The port's config object: the configuration file's factory and values,
    with the traffic's batch and compute dtype."""
    spec = cell.config["port"]
    values = dict(cell.config["config"])
    for key in ("image_size", "test_size"):
        if key in values:
            values[key] = tuple(values[key])
    values.update(batch_size=cell.traffic["batch_size"],
                  compute_dtype=cell.traffic["compute_dtype"])
    module = importlib.import_module("split_vae_torch.core.config")
    return getattr(module, spec["factory"])(**values)


def build(cell, images: np.ndarray, state_seed: int, loader_seed: int, device) -> Program:
    """The step and its state, the loader over ``images``, the running metrics."""
    from split_vae_torch.core.metrics import MeanMetrics
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.data.loader import ArrayDataset, device_resident_batches

    cfg = port_config(cell)
    family = cell.config["port"]["family"]
    if family == "spair":
        from split_vae_torch.models.spair import get_spair_model
        from split_vae_torch.train.optim import spair_optimizer
        from split_vae_torch.train.steps import make_spair_train_step
        model = get_spair_model(cfg, device=device)
        tx = spair_optimizer(cfg.learning_rate)
        step = make_spair_train_step(cfg, windowed_render=cell.traffic.get("render") == "windowed")
    elif family == "vae":
        from split_vae_torch.train.loop import build_vae_model
        from split_vae_torch.train.steps import make_vae_train_step
        model, tx = build_vae_model(cfg, tuple(cell.config["dataset"]["shape"][:2]), device=device)
        step = make_vae_train_step(cfg)
    else:
        raise ValueError(f"unknown family {family!r}")
    state = create_train_state(model, tx, seed=state_seed)
    batches = device_resident_batches(ArrayDataset(images), cfg.batch_size, repeat=True,
                                      seed=loader_seed, device=device)
    return Program(cfg, state, step, batches, MeanMetrics(),
                   [n for n, _ in model.named_parameters()])
