"""On-device augmentation (split_vae_tpu/ops/patches.py): the patch scramble.

``scramble`` splits each image into size x size patches, permutes them, and
reassembles (augmentation.py:43-57). The permutation of image b is the
argsort of its row of uniforms ``u`` [B, n], as at patches.py:75; a gather
applies it.
"""

from __future__ import annotations

from typing import Optional

import torch


def scramble_shape(x_shape, size: int):
    """Shape [B, n] of the uniforms that ``batched_scramble`` consumes."""
    b, h, w, _ = x_shape
    return (b, (h // size) * (w // size))


def batched_scramble(x: torch.Tensor, size: int, u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-image independent patch scramble of a batch [B, H, W, C]."""
    b, h, w, c = x.shape
    gh, gw = h // size, w // size
    n = gh * gw
    flat = (x.reshape(b, gh, size, gw, size, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b, n, size * size * c))
    if u is None:
        u = torch.rand((b, n), generator=generator, device=x.device)
    perm = torch.argsort(u, dim=1, stable=True)
    shuffled = torch.gather(flat, 1, perm[:, :, None].expand(b, n, size * size * c))
    return (shuffled.reshape(b, gh, gw, size, size, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h, w, c))


def augment_batch(x: torch.Tensor, kind: str, size: int = 1,
                  u: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """concat([x, view], channel) for a batch [B, H, W, C] (Augmentator.augment).

    Only ``no_op`` and ``scramble`` are ported so far.
    """
    if kind == "no_op":
        return x
    if kind == "scramble":
        return torch.cat([x, batched_scramble(x, size, u, generator)], dim=-1)
    raise NotImplementedError(f"augmentation {kind!r} is not ported yet")
