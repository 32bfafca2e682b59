"""Where the noise of a stochastic forward comes from.

Every stochastic op of the port takes its noise as a tensor. ``Noise`` hands
those tensors out in call order: drawn from a ``torch.Generator``, or
replayed from a list (the tests replay what the JAX package drew). The JAX
package draws from named streams ('sample', 'dropout'); the port has one,
and each model's docstring states where its dropout keep masks fall in it.

Data parallelism (``parallel/mesh.py``): data index ``rank`` of ``world``
(the mesh's data index and data size; every rank of a model group holds the
same rows and so draws the same noise) holds the rows [rank*b, (rank+1)*b)
of the global batch. Each draw says whether it is
``per_example`` (its leading dimension is this rank's batch, or batch-major
rows of it such as B*K cells): such a draw is taken at the global shape,
world times the leading dimension, and the rank keeps its block of rows, so
every rank's generator, seeded alike, advances alike and the N-rank draws are
the 1-rank draws. A draw shared by the whole batch (the patch permutation,
the render seed) is ``per_example=False`` and the same on every rank. The
marking is explicit at every draw site; with one rank it may be left out
(the eval sweeps and the figures run on one rank). Replayed draws follow the
same rule: a per-example one is replayed at the global shape and sliced.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch


class Noise:
    """``dtype`` is that of the normals and uniforms, drawn or replayed (float32
    unless a check runs a model in float64); a draw may ask for its own, as the
    JAX package draws a sample in the dtype of the tensor it perturbs (bfloat16
    under ``--compute_dtype bfloat16``). ``rank`` and ``world`` place this
    process's rows in the global batch: the mesh's data index and data size."""

    def __init__(self, generator: torch.Generator,
                 replay: Optional[Iterable[torch.Tensor]] = None,
                 dtype: torch.dtype = torch.float32, rank: int = 0, world: int = 1):
        self.generator = generator
        self.device = generator.device
        self.dtype = dtype
        self.rank, self.world = rank, world
        self._replay = None if replay is None else list(replay)

    def _next(self, shape, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if not self._replay:
            raise ValueError(f"replayed noise ran out at a draw of shape {tuple(shape)}")
        t = torch.as_tensor(self._replay.pop(0), dtype=dtype or self.dtype, device=self.device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed noise has shape {tuple(t.shape)}, "
                             f"the draw wants {tuple(shape)}")
        return t

    def _draw(self, shape, per_example: Optional[bool], dtype: Optional[torch.dtype],
              make: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
        """``make(shape)`` (or the next replayed draw) at the global shape when
        the draw is per example, then this rank's rows of it."""
        shape = tuple(shape)
        if self.world > 1 and per_example is None:
            raise ValueError(f"a draw of shape {shape} under data parallelism must say "
                             f"whether it is per example")
        rows = shape[0] if per_example and self.world > 1 else None
        if rows is not None:
            shape = (rows * self.world,) + shape[1:]
        t = self._next(shape, dtype) if self._replay is not None else make(shape)
        return t if rows is None else t[self.rank * rows:(self.rank + 1) * rows]

    def normal(self, shape, dtype: Optional[torch.dtype] = None, *,
               per_example: Optional[bool] = None) -> torch.Tensor:
        return self._draw(shape, per_example, dtype, lambda s: torch.randn(
            s, generator=self.generator, device=self.device, dtype=dtype or self.dtype))

    def uniform(self, shape, dtype: Optional[torch.dtype] = None, *,
                per_example: Optional[bool] = None) -> torch.Tensor:
        return self._draw(shape, per_example, dtype, lambda s: torch.rand(
            s, generator=self.generator, device=self.device, dtype=dtype or self.dtype))

    def normal_like(self, t: torch.Tensor, *, per_example: Optional[bool] = None) -> torch.Tensor:
        """Standard normals of ``t``'s shape and dtype."""
        return self.normal(t.shape, t.dtype, per_example=per_example)

    def uniform_like(self, t: torch.Tensor, *, per_example: Optional[bool] = None) -> torch.Tensor:
        """Uniforms in [0, 1) of ``t``'s shape and dtype."""
        return self.uniform(t.shape, t.dtype, per_example=per_example)

    def keep(self, shape, rate: float, *, per_example: Optional[bool] = None) -> torch.Tensor:
        """flax ``nn.Dropout``'s keep mask: True with probability 1 - rate, bool."""
        return self._draw(shape, per_example, None, lambda s: torch.rand(
            s, generator=self.generator, device=self.device) < 1.0 - rate).to(torch.bool)

    def randint(self, high: int, shape, *, per_example: Optional[bool] = None) -> torch.Tensor:
        """Integers in [0, high), int64; replayed ones are taken as they are."""
        return self._draw(shape, per_example, None, lambda s: torch.randint(
            0, high, s, generator=self.generator, device=self.device)).to(torch.int64)

    def permutation(self, n: int) -> torch.Tensor:
        """A random permutation of range(n), int64, the same on every rank; a
        replayed one is taken as it is."""
        if self._replay is not None:
            return self._next((n,)).to(torch.int64)
        return torch.randperm(n, generator=self.generator, device=self.device)

    def seed(self) -> torch.Tensor:
        """An int32 seed in [0, 2^31 - 1), as a one-element tensor on the device
        (the render kernels read it there, so drawing it needs no sync); the
        same on every rank."""
        return torch.randint(0, 2**31 - 1, (1,), generator=self.generator,
                             device=self.device, dtype=torch.int32)

    def image_seed(self, batch: int) -> torch.Tensor:
        """The render kernels' seed for this rank's ``batch`` images: ``seed()``
        plus rank*batch (the data index's), wrapped to int32 as the kernels add in uint32. The
        kernels key image i's field by seed + i, so the ranks' fields together
        are the 1-rank field of the global batch (the JAX package's
        ``_call_render_spmd``: shard j seeds with seed + j*local_b)."""
        seed = self.seed()
        if self.rank == 0:
            return seed
        wide = seed.to(torch.int64) + self.rank * batch
        return (torch.remainder(wide + 2**31, 2**32) - 2**31).to(torch.int32)

    def exhausted(self) -> bool:
        return not self._replay
