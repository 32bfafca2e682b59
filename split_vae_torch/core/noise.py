"""Where the noise of a stochastic forward comes from.

Every stochastic op of the port takes its noise as a tensor. ``Noise`` hands
those tensors out in call order: drawn from a ``torch.Generator``, or
replayed from a list (the tests replay what the JAX package drew). The JAX
package draws from named streams ('sample', 'dropout'); the port has one,
and each model's docstring states where its dropout keep masks fall in it.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


class Noise:
    """``dtype`` is that of the normals and uniforms, drawn or replayed (float32
    unless a check runs a model in float64); a draw may ask for its own, as the
    JAX package draws a sample in the dtype of the tensor it perturbs (bfloat16
    under ``--compute_dtype bfloat16``)."""

    def __init__(self, generator: torch.Generator,
                 replay: Optional[Iterable[torch.Tensor]] = None,
                 dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.device = generator.device
        self.dtype = dtype
        self._replay = None if replay is None else list(replay)

    def _next(self, shape, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if not self._replay:
            raise ValueError(f"replayed noise ran out at a draw of shape {tuple(shape)}")
        t = torch.as_tensor(self._replay.pop(0), dtype=dtype or self.dtype, device=self.device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed noise has shape {tuple(t.shape)}, "
                             f"the draw wants {tuple(shape)}")
        return t

    def normal(self, shape, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self._replay is not None:
            return self._next(shape, dtype)
        return torch.randn(tuple(shape), generator=self.generator, device=self.device,
                           dtype=dtype or self.dtype)

    def uniform(self, shape, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self._replay is not None:
            return self._next(shape, dtype)
        return torch.rand(tuple(shape), generator=self.generator, device=self.device,
                          dtype=dtype or self.dtype)

    def normal_like(self, t: torch.Tensor) -> torch.Tensor:
        """Standard normals of ``t``'s shape and dtype."""
        return self.normal(t.shape, t.dtype)

    def uniform_like(self, t: torch.Tensor) -> torch.Tensor:
        """Uniforms in [0, 1) of ``t``'s shape and dtype."""
        return self.uniform(t.shape, t.dtype)

    def keep(self, shape, rate: float) -> torch.Tensor:
        """flax ``nn.Dropout``'s keep mask: True with probability 1 - rate, bool."""
        if self._replay is not None:
            return self._next(shape).to(torch.bool)
        return torch.rand(tuple(shape), generator=self.generator, device=self.device) < 1.0 - rate

    def randint(self, high: int, shape) -> torch.Tensor:
        """Integers in [0, high), int64; replayed ones are taken as they are."""
        if self._replay is not None:
            return self._next(shape).to(torch.int64)
        return torch.randint(0, high, tuple(shape), generator=self.generator,
                             device=self.device)

    def permutation(self, n: int) -> torch.Tensor:
        """A random permutation of range(n), int64; a replayed one is taken as it is."""
        if self._replay is not None:
            return self._next((n,)).to(torch.int64)
        return torch.randperm(n, generator=self.generator, device=self.device)

    def seed(self) -> torch.Tensor:
        """An int32 seed in [0, 2^31 - 1), as a one-element tensor on the device
        (the render kernels read it there, so drawing it needs no sync)."""
        return torch.randint(0, 2**31 - 1, (1,), generator=self.generator,
                             device=self.device, dtype=torch.int32)

    def exhausted(self) -> bool:
        return not self._replay
