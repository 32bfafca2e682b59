"""Tensor parallelism inside a model group of ranks (the JAX package's 'model'
mesh axis, split_vae_tpu/parallel/mesh.py:171-192).

A sharded ``nn/common.py::Dense`` or ``Conv`` keeps the rows ``index``-th of
``count`` blocks of its weight's dim 0 (its output features; flax keeps them
on the kernel's last dim) and computes

    x -> copy_to_model(x) -> F.linear / F.conv2d on its block -> gather_features -> + bias

- ``copy_to_model``: the identity forward; backward, the all-reduce SUM of
  the input's gradient over the model group, since each rank's block
  contributes a partial sum of it;
- ``gather_features``: forward, the all-gather of the ranks' blocks along the
  last dim of the [rows, features] or NHWC output; backward, this rank's
  block of the gradient.

The bias stays whole on every rank (the JAX rule shards no leaf of one
dimension) and is added after the gather, as the bfloat16 form of the layer
adds it after the product: its gradient is then the sum over the gathered
output's gradient, equal on every rank of the group, and needs no
collective. Every activation is whole on every rank of a model group, so the
function is the unsharded layer's up to the order of a product's sums.

The collectives go through ``all_gather_cat`` and ``all_reduce_sum_``, which
a caller may wrap to time them. Both take CUDA tensors on NCCL and on gloo
alike: gloo's all-gather and all-reduce copy a CUDA tensor through the host
themselves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ModelShard:
    """A sharded layer's place: block ``index`` of ``count`` along the output
    features, over the model ``group`` (a ``torch.distributed`` group)."""

    group: Any
    index: int
    count: int

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t``'s dim 0 (a view)."""
        rows = t.shape[0] // self.count
        return t[self.index * rows:(self.index + 1) * rows]


def all_gather_cat(t: torch.Tensor, shard: ModelShard, dim: int) -> torch.Tensor:
    """The model group's ``t`` concatenated along ``dim``, in block order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.count)]
    dist.all_gather(parts, t, group=shard.group)
    return torch.cat(parts, dim=dim)


def all_reduce_sum_(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``t`` summed over the model group, in place; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=shard.group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(memory_format=torch.contiguous_format), ctx.shard), None


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard):
        ctx.shard, ctx.width = shard, y.shape[-1]
        return all_gather_cat(y, shard, dim=-1)

    @staticmethod
    def backward(ctx, g):
        start = ctx.shard.index * ctx.width
        return g[..., start:start + ctx.width].contiguous(), None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return _CopyToModel.apply(x, shard)


def gather_features(y: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return _GatherFeatures.apply(y, shard)
