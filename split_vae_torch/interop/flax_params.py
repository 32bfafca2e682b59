"""Flax parameter trees <-> the port's state_dicts.

The JAX package keeps its parameters as a nested dict named by the flax tree
(``encoder/obj_encoder/Conv_0/kernel`` in a SPAIR model,
``decoder_x/Conv_3/kernel`` in LGVae). The port's modules carry the same
names, so a leaf maps by path, with two layout rules:

- a conv ``kernel`` is HWIO in flax and a ``weight`` OIHW in torch;
- a Dense ``kernel`` is [in, out] in flax and a ``weight`` [out, in] in torch;
- a BatchNorm ``scale`` is the ``weight`` (``bias`` stays ``bias``).

A model with BatchNorm (the probe classifier) takes a flax *variables* tree,
``{"params": ..., "batch_stats": ...}``, whose ``batch_stats`` leaves ``mean``
and ``var`` are the buffers ``running_mean`` and ``running_var``;
``state_dict_to_flax`` gives such a tree back for a state_dict with buffers.

Both directions take and give plain numpy arrays on the flax side, so nothing
here needs JAX: a tree read from a checkpoint, or handed over by a test, is
nested dicts of arrays. A leaf that finds no counterpart, on either side, or
whose shape disagrees, raises. A tensor-parallel model
(``parallel/mesh.py::shard_state``) takes the whole tree, and each sharded
weight keeps its block.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from split_vae_torch.parallel.mesh import full_shapes, load_full_state_dict_


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _to_torch_layout(leaf: np.ndarray, kind: str) -> np.ndarray:
    if kind != "kernel":
        return leaf
    if leaf.ndim == 4:  # HWIO -> OIHW
        return leaf.transpose(3, 2, 0, 1)
    if leaf.ndim == 2:  # [in, out] -> [out, in]
        return leaf.T
    raise ValueError(f"a kernel of rank {leaf.ndim} has no torch layout")


def _to_flax_layout(weight: np.ndarray, kind: str) -> np.ndarray:
    if kind != "kernel":
        return weight
    if weight.ndim == 4:  # OIHW -> HWIO
        return weight.transpose(2, 3, 1, 0)
    if weight.ndim == 2:
        return weight.T
    raise ValueError(f"a weight of rank {weight.ndim} has no flax layout")


_PARAM_NAMES = {"kernel": "weight", "scale": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _is_variables(tree: Mapping) -> bool:
    return "params" in tree and set(tree) <= {"params", "batch_stats"}


def flax_to_state_dict(tree: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The flax tree (params, or a {"params", "batch_stats"} variables tree)
    as a 1-rank state_dict for ``model`` (on its devices)."""
    target = model.state_dict()
    shapes = full_shapes(model)
    if _is_variables(tree):
        parts = [(tree["params"], _PARAM_NAMES), (tree.get("batch_stats", {}), _STAT_NAMES)]
    else:
        parts = [(tree, _PARAM_NAMES)]
    out: Dict[str, torch.Tensor] = {}
    for part, names in parts:
        for path, leaf in _leaves(part):
            kind = path[-1]
            name = ".".join(path[:-1] + (names.get(kind, kind),))
            if name not in target:
                raise KeyError(f"flax leaf {'/'.join(path)} has no counterpart {name!r} in the "
                               f"model")
            value = _to_torch_layout(leaf, kind)
            want = target[name]
            if tuple(value.shape) != shapes[name]:
                raise ValueError(f"{'/'.join(path)}: shape {value.shape} maps to {name} "
                                 f"of shape {shapes[name]}")
            out[name] = torch.tensor(value, device=want.device, dtype=want.dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"model entries with no flax leaf: {missing}")
    return out


def load_flax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copies the flax tree (params or variables) into ``model``; returns the model."""
    return load_full_state_dict_(model, flax_to_state_dict(tree, model))


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse: a state_dict as a nested flax tree of numpy arrays; a
    {"params", "batch_stats"} variables tree when it holds running averages."""
    params: Dict = {}
    stats: Dict = {}
    inverse = {v: k for k, v in _STAT_NAMES.items()}
    for name, tensor in state_dict.items():
        *scopes, kind = name.split(".")
        value = tensor.detach().cpu().numpy()
        if kind in inverse:
            node, kind = stats, inverse[kind]
        else:
            node = params
            if kind == "weight":
                kind = "scale" if value.ndim == 1 else "kernel"
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[kind] = _to_flax_layout(value, kind)
    return {"params": params, "batch_stats": stats} if stats else params
