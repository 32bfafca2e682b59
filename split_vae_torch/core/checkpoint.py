"""Checkpoint / resume for the full train state (split_vae_tpu/core/checkpoint.py).

A checkpoint holds the step, the model's state_dict, the optimizer state's
tensors (in the order of its tree) and the generator's state, all on the
CPU, written with ``torch.save`` to ``checkpoint_<step>.pt``: to a ``.tmp``
file first, then renamed, so a crash never leaves a torn checkpoint. Only the
newest ``keep`` are kept. A checkpoint written on the card restores on the
CPU and the other way round; the generator's state is kept only where the
device type matches (a CUDA generator's state is not a CPU generator's).

The JAX package writes flax msgpack (``.msgpack``); ``load_weights`` reads
such a weights file into a port model through ``interop/flax_msgpack.py`` and
``interop/flax_params.py``.

Under tensor parallelism (``parallel/mesh.py::shard_state``) a checkpoint is
still the 1-rank file: ``save_checkpoint`` and ``save_weights`` all-gather the
sharded parameters and their moments over the model group first (every rank
of rank 0's model group calls them; rank 0 writes), and a restore reads the
whole file into the unsharded state, which ``shard_state`` then cuts.
``load_weights`` cuts a sharded model's blocks from the whole file.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch
from torch import nn

from split_vae_torch.core.state import TrainState
from split_vae_torch.core.state import tree_tensors as _leaves
from split_vae_torch.interop.flax_msgpack import load as load_msgpack
from split_vae_torch.interop.flax_params import load_flax_params
from split_vae_torch.parallel.mesh import (
    Mesh,
    gather_opt_state,
    gather_state_dict,
    is_main,
    load_full_state_dict_,
)

_CKPT_RE = re.compile(r"checkpoint_(\d+)\.pt$")


def _cpu_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in gather_state_dict(model).items()}


def save_checkpoint(ckpt_dir: str, state: TrainState, keep: int = 3,
                    mesh: Mesh = Mesh()) -> Optional[str]:
    """Serialize the full state; retain only the newest ``keep`` checkpoints.
    With sharded parameters, a collective of the model group; rank 0 of
    ``mesh`` writes and returns the path, the other ranks None."""
    model_state = _cpu_state_dict(state.model)
    opt_state = [t.detach().cpu() for t in _leaves(gather_opt_state(state))]
    if not is_main(mesh):
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "step": int(state.step),
        "model": model_state,
        "opt_state": opt_state,
        "generator": state.generator.get_state(),
        "generator_device": state.generator.device.type,
    }
    path = os.path.join(ckpt_dir, f"checkpoint_{state.step}.pt")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)

    if keep > 0:
        found = sorted(
            ((int(m.group(1)), fname) for fname in os.listdir(ckpt_dir)
             if (m := _CKPT_RE.match(fname))),
            reverse=True)
        for _, fname in found[keep:]:
            os.remove(os.path.join(ckpt_dir, fname))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for fname in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fname)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(ckpt_dir, fname)
    return best


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restores into the template ``state`` in place (a directory: its newest
    checkpoint); returns it. Shapes and the optimizer tree must match."""
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"No checkpoint under {path}")
        path = found
    payload: Dict[str, Any] = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    targets = _leaves(state.opt_state)
    saved = payload["opt_state"]
    if len(saved) != len(targets):
        raise ValueError(f"{path}: {len(saved)} optimizer tensors, the state has {len(targets)}")
    with torch.no_grad():
        for i, (dst, src) in enumerate(zip(targets, saved)):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"{path}: optimizer tensor {i} is {src.dtype} {tuple(src.shape)}, "
                                 f"the state's {dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
    state.step = int(payload["step"])
    if payload["generator_device"] == state.generator.device.type:
        state.generator.set_state(payload["generator"])
    else:
        print(f"{path}: the generator state is a {payload['generator_device']} generator's; "
              f"the {state.generator.device.type} generator keeps its seed")
    return state


def save_weights(path: str, model: nn.Module, mesh: Mesh = Mesh()) -> None:
    """Weights-only export (reference parity: model.save_weights .h5); as
    ``save_checkpoint``, the 1-rank tensors, written by rank 0."""
    weights = _cpu_state_dict(model)
    if not is_main(mesh):
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(weights, path)


def load_weights(path: str, model: nn.Module) -> nn.Module:
    """Loads a weights file into ``model``: the port's ``.pt``, or a
    ``.msgpack`` that the JAX package's ``save_weights`` wrote."""
    if path.endswith(".msgpack"):
        return load_flax_params(model, load_msgpack(path))
    return load_full_state_dict_(model, torch.load(path, map_location="cpu", weights_only=True))
