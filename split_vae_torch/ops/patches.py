"""On-device augmentation (split_vae_tpu/ops/patches.py): patch scramble, blur, high/low pass.

- ``scramble`` splits each image into size x size patches, permutes them and
  reassembles (augmentation.py:43-57). The permutation of image b is the
  argsort of its row of uniforms ``u`` [B, n], as at patches.py:75; a gather
  applies it (the JAX package's one-hot matmul is a TPU choice).
- ``mix_scramble`` scrambles each image with a patch size drawn from
  {1, 2, 4, 8}: all four scrambles, one chosen per image (patches.py:163-175).
- ``patch_scramble`` and ``mix_scramble`` are the one-image forms
  (patches.py:37-50, 89-94), a permutation of the patches from
  ``Noise.permutation`` (and the size's index from ``Noise.randint``).
- ``blur``: per image a sigma in [5, 10) and a half-width in {3..6}, a masked
  13-tap Gaussian, symmetric padding, separable depthwise conv
  (patches.py:97-136).
- ``high_low_pass``: a fixed Gaussian low-pass of support [-size, size] and
  the residual high-pass; concat([x, high, low]) has 9 channels.

Every draw is an optional argument: ``augment_draws`` makes a kind's draws
from a ``Noise`` (generator or replay) in the JAX package's order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from split_vae_torch.core.noise import Noise

MIX_SIZES = (1, 2, 4, 8)
_BLUR_MAX_HALFWIDTH = 6  # half-widths are drawn from {3..6}: at most 13 taps


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


def _patches(x: torch.Tensor, size: int) -> torch.Tensor:
    """The size x size patches of one image [H, W, C], row-major: [n, size, size, C]."""
    h, w, c = x.shape
    return (x.reshape(h // size, size, w // size, size, c).permute(0, 2, 1, 3, 4)
            .reshape(-1, size, size, c))


def patch_scramble(x: torch.Tensor, size: int, noise: Noise) -> torch.Tensor:
    """The size x size patches of one image [H, W, C] in the order of a
    permutation drawn from ``noise`` (augmentation.py:43-54)."""
    h, w, c = x.shape
    gh, gw = h // size, w // size
    patches = _patches(x, size)[noise.permutation(gh * gw)]
    return patches.reshape(gh, gw, size, size, c).permute(0, 2, 1, 3, 4).reshape(h, w, c)


def mix_scramble(x: torch.Tensor, noise: Noise) -> torch.Tensor:
    """One image scrambled with a patch size from MIX_SIZES: its index drawn
    from ``noise``, then the permutation at that size."""
    idx = int(noise.randint(len(MIX_SIZES), ()))
    return patch_scramble(x, MIX_SIZES[idx], noise)


def batched_mix_scramble(x: torch.Tensor, idx: torch.Tensor,
                         us: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-image patch size MIX_SIZES[idx[b]]: ``idx`` [B] in 0..3, ``us`` the
    uniforms of the four scrambles ([B, n] for each size of MIX_SIZES)."""
    candidates = torch.stack([batched_scramble(x, s, u) for s, u in zip(MIX_SIZES, us)])
    pick = idx.to(torch.int64)[None, :, None, None, None].expand(1, *x.shape)
    return torch.gather(candidates, 0, pick)[0]


def _symmetric_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """numpy 'symmetric' padding (the edge pixel repeats) of H and W of [B, H, W, C]."""
    for dim in (1, 2):
        n = x.shape[dim]
        x = torch.cat([x.narrow(dim, 0, r).flip(dim), x, x.narrow(dim, n - r, r).flip(dim)],
                      dim=dim)
    return x


def _separable_blur(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Symmetric pad + depthwise separable blur of [B, H, W, C] with one 1-D
    kernel [B, taps] (or [1, taps] for all) per image."""
    b, h, w, c = x.shape
    taps = kernels.shape[-1]
    r = (taps - 1) // 2
    xp = _symmetric_pad(x, r).permute(0, 3, 1, 2)              # [B, C, H+2r, W+2r]
    xp = xp.reshape(1, b * c, h + 2 * r, w + 2 * r)
    kern = kernels.expand(b, taps).repeat_interleave(c, dim=0)  # [B*C, taps]
    out = F.conv2d(xp, kern.reshape(b * c, 1, taps, 1), groups=b * c)
    out = F.conv2d(out, kern.reshape(b * c, 1, 1, taps), groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def gaussian_blur(x: torch.Tensor, std: torch.Tensor, halfwidth: torch.Tensor) -> torch.Tensor:
    """Gaussian blur of each image of [B, H, W, C] with its own sigma ``std``
    [B] and half-width ``halfwidth`` [B] (augmentation.py:83-94)."""
    r = _BLUR_MAX_HALFWIDTH
    offs = torch.arange(-r, r + 1, dtype=x.dtype, device=x.device)[None, :]
    vals = torch.exp(-0.5 * torch.square(offs / std.to(x.dtype)[:, None]))
    vals = vals * (offs.abs() <= halfwidth.to(x.dtype)[:, None]).to(x.dtype)
    return _separable_blur(x, vals / vals.sum(dim=1, keepdim=True))


def high_low_pass(x: torch.Tensor, size: int, mean: float = 0.0, std: float = 1.0):
    """(high, low) of a batch [B, H, W, C]: a Gaussian low-pass of support
    [-size, size] and the residual (augmentation.py:97-101)."""
    offs = torch.arange(-size, size + 1, dtype=x.dtype, device=x.device)
    vals = torch.exp(-0.5 * torch.square((offs - mean) / std))
    low = _separable_blur(x, (vals / vals.sum())[None, :])
    return x - low, low


def augment_draws(kind: str, x_shape, size: int, noise: Noise):
    """The draws ``augment_batch`` takes as ``u`` for this kind, from ``noise``
    in the JAX package's order: scramble [B, n] uniforms; mix_scramble
    (idx [B], then four [B, n_s] uniforms); blur (std [B] in [5, 10),
    half-width [B] in {3..6}); none for no_op and high_low_pass."""
    b = x_shape[0]
    if kind == "scramble":
        return noise.uniform(scramble_shape(x_shape, size), per_example=True)
    if kind == "mix_scramble":
        idx = noise.randint(len(MIX_SIZES), (b,), per_example=True)
        return (idx, [noise.uniform(scramble_shape(x_shape, s), per_example=True)
                     for s in MIX_SIZES])
    if kind == "blur":
        return (5.0 + 5.0 * noise.uniform((b,), per_example=True),
                3 + noise.randint(4, (b,), per_example=True))
    return None


def augment_batch(x: torch.Tensor, kind: str, size: int = 1, u=None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """concat([x, view(s)], channel) for a batch [B, H, W, C] (Augmentator.augment).

    ``u`` are the kind's draws as ``augment_draws`` lays them out; if None
    they are drawn from ``generator``, which is then required.
    """
    if kind == "no_op":
        return x
    if kind == "high_low_pass":
        return torch.cat([x, *high_low_pass(x, size)], dim=-1)
    if kind not in ("scramble", "mix_scramble", "blur"):
        raise ValueError(f"Unknown augmentation kind: {kind!r}")
    if u is None:
        if generator is None:
            raise ValueError(f"augmentation {kind!r} needs its draws ``u`` or a generator")
        u = augment_draws(kind, x.shape, size, Noise(generator))
    if kind == "scramble":
        view = batched_scramble(x, size, u)
    elif kind == "mix_scramble":
        view = batched_mix_scramble(x, *u)
    else:
        view = gaussian_blur(x, *u)
    return torch.cat([x, view], dim=-1)


def augmented_channels(kind: str, base_channels: int = 3) -> int:
    """Channel count of the augmented input that the models read."""
    if kind == "no_op":
        return base_channels
    if kind == "high_low_pass":
        return 3 * base_channels
    return 2 * base_channels
