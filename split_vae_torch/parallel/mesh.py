"""Data parallelism, one process a GPU (split_vae_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') mesh over the devices of one or more
processes and lets XLA insert the gradient psum. The port runs one process a
GPU under ``torch.distributed``, NCCL on the card and gloo on the CPU (or
where a caller asks for it), and the train step reduces the gradients itself
with one flat all-reduce (``all_reduce_mean_``) between
``torch.autograd.grad`` and the optimizer. ``DistributedDataParallel`` does
not serve a step that takes its gradients with ``torch.autograd.grad``.

An N-rank step at the global batch B equals the 1-rank step at B, up to the
order of the reduction:

- every rank holds the same state (``broadcast_state_`` after a build or a
  restore, from rank 0);
- rank r takes the rows ``rows(mesh, B)`` = [r*b, (r+1)*b) of each global
  batch, b = B / N (the JAX single-process mesh's split of the batch axis);
- every draw whose leading dimension is the batch is drawn at the global
  shape from a generator that each rank seeds and advances alike, and the
  rank keeps its rows (``core/noise.py``), as threefry's draws do not depend
  on the sharding; the render kernels key image i's noise field by seed + i,
  so rank r offsets the render seed by r*b (``nn/spair_nets.py``);
- each loss is a mean over the batch, so the mean of the ranks' gradients is
  the global batch's.

A 1-rank mesh does no collective at all, as a 1-device mesh changes nothing
in the JAX package (``activate_mesh``, mesh.py:86-116). Tensor parallelism
(``num_model > 1``, the JAX package's ``infer_param_sharding``) is not ported
yet and is refused.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from split_vae_torch.core.state import tree_tensors

TENSOR_PARALLEL = ("tensor parallelism (num_model_shards > 1, the JAX package's "
                   "infer_param_sharding) is the next slice of ROADMAP A8; the port runs data "
                   "parallelism only")


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world. ``backend`` is None
    when no process group exists (one process, nothing initialized)."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None


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
    ``backend`` None is NCCL where CUDA is available, else gloo. A failure to
    initialize propagates: a job that asked for N processes never goes on as
    one.
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
    dist.init_process_group(backend or ("nccl" if torch.cuda.is_available() else "gloo"),
                            init_method=f"tcp://{coordinator}", world_size=num_processes or 1,
                            rank=process_id)


def create_mesh(num_data: int = 0, num_model: int = 1,
                device: Optional[torch.device] = None) -> Mesh:
    """This process's Mesh over the process group (one process when there is
    none). ``num_data`` 0 means the whole world, as in the JAX package; any
    other count but the world size is refused, as is ``num_model`` > 1.
    ``device`` None is cuda:{local rank} where CUDA is available, else the CPU."""
    if num_model > 1:
        raise NotImplementedError(TENSOR_PARALLEL)
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped else 1
    if num_data not in (0, world):
        raise ValueError(f"num_data_shards {num_data}: data parallelism takes one process a "
                         f"GPU, so it is 0 (all) or the world size, {world} (ROADMAP A8)")
    local = local_rank(rank if grouped else None)
    if device is None:
        device = torch.device("cuda", local) if torch.cuda.is_available() else torch.device("cpu")
    return Mesh(rank, world, local, torch.device(device),
                dist.get_backend() if grouped else None)


def is_main(mesh: Mesh) -> bool:
    """Rank 0: the one that writes records, checkpoints and weights."""
    return mesh.rank == 0


def barrier(mesh: Mesh) -> None:
    if mesh.world > 1:
        dist.barrier()


def rows(mesh: Mesh, global_b: int) -> slice:
    """This rank's rows of a global batch of ``global_b``."""
    if global_b % mesh.world:
        raise ValueError(f"batch_size {global_b} must divide evenly over {mesh.world} processes")
    b = global_b // mesh.world
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


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


def flat_all_reduce_mean_(tensors: Sequence[torch.Tensor], world: int) -> None:
    """The mean over the group, in place, through one buffer a dtype: SUM,
    then a division by ``world`` (gloo has no AVG, so both backends compute
    the same thing)."""
    def reduce(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(world)

    _through_flat_(tensors, reduce)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """The ranks' mean of each tensor, in place on every rank (XLA's psum
    over 'data', divided by its size); nothing on a 1-rank mesh."""
    if mesh.world > 1:
        flat_all_reduce_mean_(tensors, mesh.world)


def _comm_device(mesh: Mesh) -> torch.device:
    """Where a small host value goes for a collective: NCCL takes CUDA
    tensors only, gloo takes either."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def broadcast_state_(state, mesh: Mesh) -> None:
    """Rank 0's train state on every rank, in place: the model's parameters
    and buffers, the optimizer's state, the step and the generator's state
    (split_vae_tpu's ``shard_state``: every process holds the same state);
    nothing on a 1-rank mesh."""
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
    """The ranks' mean of each host number, in float64; the values unchanged
    on a 1-rank mesh."""
    if mesh.world == 1:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64, device=_comm_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return (t / mesh.world).tolist()


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's picklable ``obj`` on every rank."""
    if mesh.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_comm_device(mesh))
    return box[0]
