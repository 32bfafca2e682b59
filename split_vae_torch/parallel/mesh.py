"""Data and tensor parallelism, one process a GPU (split_vae_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') mesh over the devices of one or more
processes and lets XLA insert every collective. The port runs one process a
GPU under ``torch.distributed``, NCCL on the card and gloo on the CPU (or
where a caller asks for it), and writes each collective out. The ranks form a
grid of ``num_data`` x ``num_model``: global rank r is data index
r // num_model and model index r % num_model, as ``create_mesh`` reshapes the
devices. The ranks of one data index form a model group; the ranks of one
model index form a data group.

Data parallelism (``num_model`` 1): an N-rank step at the global batch B
equals the 1-rank step at B, up to the order of the reduction:

- every rank holds the same state (``broadcast_state_`` after a build or a
  restore, from rank 0);
- data index d takes the rows ``rows(mesh, B)`` = [d*b, (d+1)*b) of each
  global batch, b = B / num_data (the JAX single-process mesh's split of the
  batch axis);
- every draw whose leading dimension is the batch is drawn at the global
  shape from a generator that each rank seeds and advances alike, and the
  rank keeps its rows (``core/noise.py``), as threefry's draws do not depend
  on the sharding; the render kernels key image i's noise field by seed + i,
  so data index d offsets the render seed by d*b (``nn/spair_nets.py``);
- each loss is a mean over the batch, so the mean of the data group's
  gradients (one flat all-reduce, ``all_reduce_mean_``, between
  ``torch.autograd.grad`` and the optimizer) is the global batch's.
  ``DistributedDataParallel`` does not serve a step that takes its gradients
  with ``torch.autograd.grad``.

Tensor parallelism (``num_model`` > 1): ``infer_param_sharding`` is the JAX
rule, and ``shard_state`` keeps on each rank its block of every sharded
weight's output rows and of that weight's Adam moments; the layer computes
its block of the output between the model group's collectives
(``parallel/tensor.py``). Every rank of a model group takes the same rows and
draws, so its activations are whole and equal; a sharded weight's gradient
is reduced over its data group, a replicated leaf's over the whole world
(``reduce_gradients_``: the mean over the model group of equal values keeps
the group's copies bit-equal where the card's sums are not reproducible). The optimizer takes a sharded gradient's full norm
and skips a non-finite update on every rank of the group together
(``model_reduce``). ``gather_state_dict`` and ``gather_opt_state`` give the
1-rank tensors back (checkpoints, weights, the evals' replica).

A 1-rank mesh does no collective at all, as a 1-device mesh changes nothing
in the JAX package (``activate_mesh``, mesh.py:86-116).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from split_vae_torch.core.state import TrainState, tree_tensors
from split_vae_torch.parallel.tensor import ModelShard, all_gather_cat
from split_vae_torch.train.optim import ModelReduce


@dataclass(frozen=True)
class Mesh:
    """This process's place in the grid of ``world`` ranks, ``model_size`` to
    a model group. ``backend`` is None when no process group exists (one
    process, nothing initialized). ``data_group`` and ``model_group`` are the
    ``torch.distributed`` groups of this rank's data and model groups (None:
    the whole world, or a group of one)."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    model_size: int = 1
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def data_size(self) -> int:
        return self.world // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size


def local_rank(process_id: Optional[int] = None) -> int:
    """This process's GPU on its host: torchrun's LOCAL_RANK; else, with a
    process id, that id modulo the host's GPU count (all processes on one
    host); else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if process_id is not None and torch.cuda.is_available():
        return process_id % torch.cuda.device_count()
    return 0


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None) -> None:
    """Joins the process group: once a process, before ``create_mesh``.

    A no-op when nothing asks for more than one process (no coordinator, and
    num_processes None, 0 or 1, and no torchrun WORLD_SIZE), or when the group
    exists already. Otherwise ``init_process_group`` at
    ``tcp://{coordinator}`` with ``num_processes`` and ``process_id``; without
    flags it takes torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT.
    ``backend`` None is NCCL, which raises without CUDA before any
    rendezvous: a CPU group asks for gloo. A failure to initialize
    propagates: a job that asked for N processes never goes on as one.
    """
    if coordinator is None and num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if coordinator is None and (num_processes or 1) <= 1:
        return
    if dist.is_initialized():
        return
    if coordinator is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError(f"--num_processes {num_processes} without --coordinator takes "
                             f"torchrun's MASTER_ADDR and MASTER_PORT, which are not set "
                             f"(ROADMAP A8)")
        coordinator = f"{addr}:{port}"
    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError("--coordinator needs --process_id (or torchrun's RANK) (ROADMAP A8)")
        process_id = int(os.environ["RANK"])
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available for the NCCL backend; pass backend='gloo' "
                           "to join the group on the CPU")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes or 1, rank=process_id)


def create_mesh(num_data: int = 0, num_model: int = 1,
                device: Optional[torch.device] = None) -> Mesh:
    """This process's Mesh over the process group (one process when there is
    none): the world as a grid of ``num_data`` x ``num_model`` ranks, rank r at
    data index r // num_model and model index r % num_model. ``num_data`` 0
    means all the ranks that remain, as in the JAX package; ``num_model``
    must divide the world, and ``num_data`` x ``num_model`` must be the world.
    Every rank makes every group, in one order (``dist.new_group`` is a
    collective of the whole world). ``device`` None is cuda:{local rank},
    which raises without CUDA: a CPU mesh asks for the CPU."""
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped else 1
    if num_model < 1 or world % num_model:
        raise ValueError(f"num_model_shards {num_model} does not divide the world of {world} "
                         f"processes (one process a GPU) (ROADMAP A8)")
    if num_data not in (0, world // num_model):
        raise ValueError(f"num_data_shards {num_data}: one process a GPU, so num_data_shards x "
                         f"num_model_shards {num_model} is the world size, {world}, or "
                         f"num_data_shards is 0 (all) (ROADMAP A8)")
    data_group = model_group = None
    if num_model > 1:
        n_data = world // num_model
        data_groups = [dist.new_group([d * num_model + m for d in range(n_data)])
                       for m in range(num_model)]
        model_groups = [dist.new_group([d * num_model + m for m in range(num_model)])
                        for d in range(n_data)]
        data_group, model_group = data_groups[rank % num_model], model_groups[rank // num_model]
    local = local_rank(rank if grouped else None)
    if device is None:
        from split_vae_torch.models.spair import require_device

        device = require_device(torch.device("cuda", local))
    return Mesh(rank, world, local, torch.device(device),
                dist.get_backend() if grouped else None, num_model, data_group, model_group)


def is_main(mesh: Mesh) -> bool:
    """Rank 0: the one that writes records, checkpoints and weights."""
    return mesh.rank == 0


def barrier(mesh: Mesh) -> None:
    if mesh.world > 1:
        dist.barrier()


def rows(mesh: Mesh, global_b: int) -> slice:
    """This rank's rows of a global batch of ``global_b``: its data index's."""
    if global_b % mesh.data_size:
        raise ValueError(f"batch_size {global_b} must divide evenly over {mesh.data_size} "
                         f"processes")
    b = global_b // mesh.data_size
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def _through_flat_(tensors: Sequence[torch.Tensor], collective) -> None:
    """Each dtype's tensors flattened into one buffer, ``collective(buffer)``
    on it, and the buffer copied back into the tensors."""
    for group in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        with torch.no_grad():
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))


def flat_all_reduce_mean_(tensors: Sequence[torch.Tensor], world: int, group=None) -> None:
    """The mean over ``group`` (of ``world`` ranks; None: the whole world), in
    place, through one buffer a dtype: SUM, then a division by ``world``
    (gloo has no AVG, so both backends compute the same thing)."""
    def reduce(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(world)

    _through_flat_(tensors, reduce)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """The data group's mean of each tensor, in place on every rank of it
    (XLA's psum over 'data', divided by its size); nothing on a data group of
    one. A model group's ranks hold equal means already and are not reduced."""
    if mesh.data_size > 1:
        flat_all_reduce_mean_(tensors, mesh.data_size, mesh.data_group)


def reduce_gradients_(grads: Sequence[torch.Tensor], model: nn.Module, mesh: Mesh) -> None:
    """The train step's reduction of ``model``'s gradients, in place: their
    mean over the data group (``all_reduce_mean_``). With a model group, a
    sharded weight's block goes over its data group, whose ranks hold that
    block; every other gradient over the whole world. The ranks of a model
    group compute the same replicated gradients, but on the card not bit for
    bit (cuDNN's and the scatters' atomic sums run in another order from run
    to run); their mean over the group gives each rank the same bits, so the
    copies of a replicated leaf stay equal across the group, as the JAX
    package's one replicated array is."""
    if mesh.model_size == 1:
        all_reduce_mean_(grads, mesh)
        return
    blocks = {id(m.weight) for m in model.modules() if getattr(m, "shard", None) is not None}
    params = list(model.parameters())
    all_reduce_mean_([g for g, p in zip(grads, params) if id(p) in blocks], mesh)
    flat_all_reduce_mean_([g for g, p in zip(grads, params) if id(p) not in blocks], mesh.world)


def _comm_device(mesh: Mesh) -> torch.device:
    """Where a small host value goes for a collective: NCCL takes CUDA
    tensors only, gloo takes either."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def broadcast_state_(state, mesh: Mesh) -> None:
    """Rank 0's train state on every rank, in place: the model's parameters
    and buffers, the optimizer's state, the step and the generator's state
    (split_vae_tpu's ``shard_state``: every process holds the same state);
    nothing on a 1-rank mesh. It runs before ``shard_state``, on the whole
    tensors."""
    if mesh.world == 1:
        return
    tensors = list(state.model.state_dict().values()) + tree_tensors(state.opt_state)
    _through_flat_(tensors, lambda flat: dist.broadcast(flat, src=0))
    dev = _comm_device(mesh)
    step = torch.tensor([state.step], dtype=torch.int64, device=dev)
    gen = state.generator.get_state().to(dev)
    dist.broadcast(step, src=0)
    dist.broadcast(gen, src=0)
    state.step = int(step.item())
    state.generator.set_state(gen.cpu())


def all_reduce_mean_values(values: Sequence[float], mesh: Mesh) -> List[float]:
    """The data group's mean of each host number, in float64; the values
    unchanged on a data group of one."""
    if mesh.data_size == 1:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64, device=_comm_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return (t / mesh.data_size).tolist()


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's picklable ``obj`` on every rank."""
    if mesh.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_comm_device(mesh))
    return box[0]


# ---------------------------------------------------------------- tensor parallelism

def infer_param_sharding(model: nn.Module, mesh: Mesh, min_size: int = 1 << 15) -> List[str]:
    """The JAX tensor-parallel rule (split_vae_tpu/parallel/mesh.py:171-192):
    the names of the parameters sharded over the model group, in the model's
    order. A leaf is sharded when it has two dimensions or more, at least
    ``min_size`` elements and output features that the model group's size
    divides: flax's last dim, the port's dim 0. Every other leaf is
    replicated; none on a 1-model-rank mesh. Only a Dense or Conv weight
    (the layers with a ``shard``) can qualify: the port's models hold no
    other parameter of two dimensions."""
    n = mesh.model_size
    if n == 1:
        return []
    names = []
    for prefix, module in model.named_modules():
        if not hasattr(module, "shard"):
            continue
        w = module.weight
        if w.dim() >= 2 and w.numel() >= min_size and w.shape[0] % n == 0:
            names.append(f"{prefix}.weight" if prefix else "weight")
    return names


def _owner(model: nn.Module, name: str) -> nn.Module:
    return model.get_submodule(name.rpartition(".")[0])


def map_params(tree, n_params: int, fn):
    """optax's ``tree_map_params`` over an optimizer state: ``fn(i, leaf)`` on
    every leaf of a params-shaped list (a list of ``n_params`` tensors: Adam's
    mu, nu and nu_max, in parameter order); the scalar bookkeeping (counts)
    and the tuples around them as they are."""
    if isinstance(tree, list) and len(tree) == n_params and all(
            isinstance(t, torch.Tensor) for t in tree):
        return [fn(i, t) for i, t in enumerate(tree)]
    if isinstance(tree, tuple):
        mapped = [map_params(t, n_params, fn) for t in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    return tree


def _sharded_indices(model: nn.Module, names: Sequence[str]) -> List[int]:
    order = [n for n, _ in model.named_parameters()]
    return [order.index(n) for n in names]


def shard_state(state: TrainState, mesh: Mesh, names: Optional[Sequence[str]] = None
                ) -> TrainState:
    """Keeps on this rank its block of every sharded parameter (``names``;
    None: ``infer_param_sharding`` at its default ``min_size``) and of that
    parameter's params-shaped optimizer leaves, in place; the rest stays
    whole (split_vae_tpu's ``shard_state``: the moments take their
    parameter's placement, the counts are replicated). It runs after
    ``broadcast_state_``, so each block is cut from the one whole glorot
    initialization. The optimizer must have been built with
    ``model_reduce(mesh, state.model, names)``. Nothing on a 1-model-rank
    mesh."""
    names = infer_param_sharding(state.model, mesh) if names is None else list(names)
    if not names:
        return state
    shard = ModelShard(mesh.model_group, mesh.model_rank, mesh.model_size)
    n_params = len(state.params)
    sharded = set(_sharded_indices(state.model, names))
    with torch.no_grad():
        for name in names:
            module = _owner(state.model, name)
            module.weight = nn.Parameter(shard.block(module.weight).clone())
            module.shard = shard
        state.opt_state = map_params(state.opt_state, n_params,
                                     lambda i, t: shard.block(t).clone() if i in sharded else t)
    return state


def model_reduce(mesh: Mesh, model: nn.Module, names: Sequence[str]) -> Optional[ModelReduce]:
    """What the optimizer needs of the model group (``train/optim.py``), for
    ``model`` with the sharded parameters ``names``: each sharded gradient's
    squared norm summed over the group (one all-reduce for all of them), and
    the AND of the finite flag over the group. None on a 1-model-rank mesh,
    where the optimizer does no collective."""
    if mesh.model_size == 1:
        return None
    index = _sharded_indices(model, names)
    group = mesh.model_group

    def norms(grads, norms):
        out = list(norms)
        if index:
            sq = torch.stack([norms[i] * norms[i] for i in index])
            dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=group)
            for i, full in zip(index, torch.sqrt(sq)):
                out[i] = full
        return out

    def all_(flag):
        f = flag.to(torch.int32).reshape(1)
        dist.all_reduce(f, op=dist.ReduceOp.MIN, group=group)
        return f.reshape(()) > 0

    return ModelReduce(norms, all_)


def _shards(model: nn.Module) -> Dict[str, ModelShard]:
    return {(f"{p}.weight" if p else "weight"): m.shard for p, m in model.named_modules()
            if getattr(m, "shard", None) is not None}


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's 1-rank state_dict: each sharded weight all-gathered over
    the model group (a collective of every rank of the group), the rest as it
    is; the state_dict itself on a 1-model-rank mesh."""
    shards = _shards(model)
    return {k: all_gather_cat(v, shards[k], 0) if k in shards else v
            for k, v in model.state_dict().items()}


def gather_opt_state(state: TrainState):
    """The optimizer state of the 1-rank step: every sharded parameter's
    params-shaped leaves all-gathered over the model group (a collective of
    every rank of the group)."""
    shards = _shards(state.model)
    if not shards:
        return state.opt_state
    by_index = {i: shards[n] for i, (n, _) in enumerate(state.model.named_parameters())
                if n in shards}
    return map_params(state.opt_state, len(state.params),
                      lambda i, t: all_gather_cat(t, by_index[i], 0) if i in by_index else t)


def load_full_state_dict_(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> nn.Module:
    """Loads a 1-rank state_dict into ``model``, each sharded weight's block
    cut from it; ``load_state_dict`` on an unsharded model."""
    shards = _shards(model)
    if shards:
        state_dict = {k: shards[k].block(v) if k in shards else v for k, v in state_dict.items()}
    model.load_state_dict(state_dict, strict=True)
    return model


def full_shapes(model: nn.Module) -> Dict[str, tuple]:
    """The 1-rank shape of each state_dict entry of ``model``."""
    shards = _shards(model)
    return {k: ((v.shape[0] * shards[k].count,) + tuple(v.shape[1:]) if k in shards
                else tuple(v.shape)) for k, v in model.state_dict().items()}
