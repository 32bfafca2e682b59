"""Plain float32 building blocks of the frozen reference steps.

Layers with flax's conventions (NHWC tensors, TF ``SAME`` padding, Dense
weights [out, in], Conv weights OIHW), the bilinear sampling of the SPAIR
crop and paste as four taps gathered from the sample coordinates, the
render's composite and its Philox-4x32-10 noise, the loss primitives, and
the optimizer (per-tensor clip, Adam with the Keras epsilon, the skip of a
non-finite update). Everything here is written from the published maths of
SPLIT and imports torch alone; nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of TF SAME: the odd pixel on the high side."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Dense(nn.Module):
    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """A convolution of NHWC tensors with TF padding ('SAME' or 'VALID')."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: str = "SAME"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.padding = stride, padding

    def conv_nchw(self, x):
        if self.padding == "SAME":
            k = self.weight.shape[-1]
            t, b = same_pads(x.shape[2], k, self.stride)
            left, right = same_pads(x.shape[3], k, self.stride)
            x = F.pad(x, (left, right, t, b))
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)

    def forward(self, x):
        return self.conv_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ResizeConv(Conv):
    """The half-pixel bilinear resize to ``out_hw``, then a SAME conv: the chain
    itself, the upsampled tensor formed."""

    def __init__(self, cin: int, cout: int, k: int, out_hw: Tuple[int, int]):
        super().__init__(cin, cout, k)
        self.out_hw = tuple(out_hw)

    def forward(self, x):
        return super().forward(resize_bilinear(x, *self.out_hw))


def resize_bilinear(x, h: int, w: int):
    """tf.image.resize(bilinear) of NHWC when upsampling (half-pixel centres)."""
    up = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1)


def flatten(x):
    return x.reshape(x.shape[0], -1)


# --------------------------------------------------------------------------
# Weights: glorot-uniform weights and zero biases from one generator, in one
# draw, by parameter name, so any two modules with the same names and shapes
# get the same tensors whatever the order of their parameters.
# --------------------------------------------------------------------------


def glorot_bound(shape) -> float:
    if len(shape) < 2:
        return 0.0
    receptive = math.prod(shape[2:])
    return math.sqrt(6.0 / (shape[1] * receptive + shape[0] * receptive))


def init_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: shape} -> {name: float32 tensor}: uniform in +-glorot bound
    (zero for 1-D tensors), drawn in one call in the sorted order of names."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=g, device=device)
    bounds = torch.repeat_interleave(
        torch.tensor([glorot_bound(shapes[n]) for n in names], device=device),
        torch.tensor(sizes, device=device))
    flat = (2.0 * u - 1.0) * bounds
    return {n: t.reshape(shapes[n]) for n, t in zip(names, flat.split(sizes))}


def load_weights(module: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copies ``weights`` into the module's parameters, which must have the
    same names and shapes."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: {sorted(set(params) ^ set(weights))[:6]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])


# --------------------------------------------------------------------------
# Bilinear sampling as taps: the rows and columns of the SPAIR transforms
# interpolate between the two clamped neighbours of each sample coordinate;
# where both clamp to one index the weights cancel exactly (nothing sampled).
# --------------------------------------------------------------------------


def taps(coords, n: int):
    """(i0, i1, w0, w1) of sample coordinates in [0, n): clamped indices and weights."""
    x0 = torch.floor(coords)
    x0c = torch.clamp(x0, 0.0, n - 1.0)
    x1c = torch.clamp(x0 + 1.0, 0.0, n - 1.0)
    return x0c.long(), x1c.long(), x1c - coords, coords - x0c


def sample_rows(src, coords, n: int):
    """src [B,K,n,W,C] at row coordinates [B,K,P] -> [B,K,P,W,C]."""
    i0, i1, w0, w1 = taps(coords, n)
    shape = coords.shape + src.shape[3:]

    def rows(i):
        return torch.gather(src, 2, i[..., None, None].expand(shape))

    return w0[..., None, None] * rows(i0) + w1[..., None, None] * rows(i1)


def sample_cols(src, coords, n: int):
    """src [B,K,P,n,C] at column coordinates [B,K,Q] -> [B,K,P,Q,C]."""
    i0, i1, w0, w1 = taps(coords, n)
    b, k, p, _, c = src.shape
    shape = (b, k, p, coords.shape[2], c)

    def cols(i):
        return torch.gather(src, 3, i[:, :, None, :, None].expand(shape))

    return w0[:, :, None, :, None] * cols(i0) + w1[:, :, None, :, None] * cols(i1)


# The SPAIR cells' box parameterisation (spair/utils.py of the reference).
CELL_RATIO = (2.0 * 12.0) / 48.0


def cell_bias(n: int) -> List[float]:
    if n == 1:
        return [0.0]
    return [(2.0 - CELL_RATIO) * i / (n - 1) - (1.0 - 0.5 * CELL_RATIO) for i in range(n)]


def box_params(z_where):
    """z_where [B,gh,gw,4] -> (sx, sy, tx, ty), each [B, gh*gw]."""
    b, gh, gw, _ = z_where.shape
    bx = torch.tensor(cell_bias(gw), device=z_where.device)[None, None, :]
    by = torch.tensor(cell_bias(gh), device=z_where.device)[None, :, None]
    sx = 0.5 * torch.sigmoid(z_where[..., 0])
    sy = 0.5 * torch.sigmoid(z_where[..., 1])
    tx = 0.5 * torch.tanh(z_where[..., 2]) + bx
    ty = 0.5 * torch.tanh(z_where[..., 3]) + by
    return tuple(t.reshape(b, gh * gw) for t in (sx, sy, tx, ty))


def grid_coords(scale, trans, out_size: int, in_size: int):
    """Sample coordinates [B,K,out_size] in input pixels of an affine along one axis."""
    grid = torch.linspace(-1.0, 1.0, out_size, device=scale.device)
    return 0.5 * (scale[..., None] * grid + trans[..., None] + 1.0) * (in_size - 1)


def crop(img, z_where, size: int):
    """Glimpses [B,K,size,size,C] of img [B,H,W,C] at the cells' boxes."""
    b, h, w, c = img.shape
    sx, sy, tx, ty = box_params(z_where)
    ys, xs = grid_coords(sy, ty, size, h), grid_coords(sx, tx, size, w)
    src = img[:, None].expand(b, ys.shape[1], h, w, c)
    return sample_cols(sample_rows(src, ys, h), xs, w)


def paste(objs, z_where, hw: Tuple[int, int], eps: float = 1e-5):
    """objs [B,K,h,w,C] on canvases [B,K,H,W,C] by the inverse of the crop's affine."""
    h, w = objs.shape[2], objs.shape[3]
    sx, sy, tx, ty = box_params(z_where)
    ys = grid_coords(1.0 / (sy + eps), -ty / (sy + eps), hw[0], h)
    xs = grid_coords(1.0 / (sx + eps), -tx / (sx + eps), hw[1], w)
    return sample_cols(sample_rows(objs, ys, h), xs, w)


def clip_strict(x, lo: float, hi: float):
    """clip(x, lo, hi) whose gradient passes only strictly inside (lo, hi)."""
    return torch.where((x > lo) & (x < hi), x, x.detach().clamp(lo, hi))


def composite(canvases, z_pres, depth_w, bg, noise=None):
    """Depth-aware alpha composite of canvases [B,K,H,W,C+1] (RGB, alpha) over
    bg [B,H,W,C]; ``noise`` [B,K,H,W,C] is added to the RGB before clipping."""
    c = canvases.shape[-1] - 1
    rgb = canvases[..., :c]
    alpha = clip_strict(canvases[..., c:], 1e-8, 1.0)
    if noise is not None:
        rgb = rgb + noise
    rgb = clip_strict(rgb, 0.0, 1.0)
    zp = z_pres[:, :, None, None, None]
    wd = depth_w[:, :, None, None, None]
    transp = zp * alpha
    imp = transp * wd
    s1 = torch.sum(imp * rgb, dim=1)
    s2 = torch.sum(imp, dim=1)
    s3 = torch.sum(transp * imp, dim=1)
    d = s2 + 1e-8
    ac = s3 / d
    return ac * (s1 / d) + (1.0 - ac) * bg


# --------------------------------------------------------------------------
# The render noise: Philox-4x32-10 (Salmon et al., SC 2011) keyed by
# (seed + image, 0) with the element's position as the counter, one standard
# normal from the first two words by Box-Muller. Integers < 2^32 in int64.
# --------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def philox_normal(keys, counters):
    """keys [B,1] and counters [1,N] (int64, < 2^32) -> standard normals [B,N]."""
    c0 = (counters + 0 * keys)
    c1 = torch.zeros_like(c0)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = keys, 0
    for _ in range(10):
        p0 = c0 * _M0  # the 64-bit product, wrapped; its two halves below
        p1 = c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK) ^ c1 ^ k0, p1 & _MASK,
                          ((p0 >> 32) & _MASK) ^ c3 ^ k1, p0 & _MASK)
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    scale = 2.3283064365386963e-10
    u1 = (c0.to(torch.float32) + 0.5) * scale
    u2 = (c1.to(torch.float32) + 0.5) * scale
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.283185307179586 * u2)


def render_noise(seed: int, b: int, k: int, c: int, h: int, w: int, device):
    """The normals [B,K,H,W,C] that image i draws with key seed + i (uint32),
    element (k, c, y, x) at counter ((k*C + c)*H + y)*W + x."""
    keys = ((seed + torch.arange(b, device=device, dtype=torch.int64)) & _MASK)[:, None]
    counters = torch.arange(k * c * h * w, device=device, dtype=torch.int64)[None, :]
    return philox_normal(keys, counters).reshape(b, k, c, h, w).permute(0, 1, 3, 4, 2)


# --------------------------------------------------------------------------
# Losses and distributions
# --------------------------------------------------------------------------


def safe_log(v, eps: float = 1e-8):
    """log(v + eps), a non-finite value replaced by -100."""
    out = torch.log(v + eps)
    return torch.where(torch.isfinite(out), out, torch.full_like(out, -100.0))


def mean_sum(x):
    """Mean over the batch, sum over the rest."""
    return torch.mean(torch.sum(x.reshape(x.shape[0], -1), dim=1))


def bernoulli_xent(label, pred):
    return -(label * safe_log(pred) + (1.0 - label) * safe_log(1.0 - pred))


def kl_normal(mean, sigma, log=torch.log):
    """KL(N(mean, sigma^2) || N(0, 1)) summed over all but the batch, batch-meaned."""
    log_var = log(torch.square(sigma))
    return mean_sum(-0.5 * (1.0 + log_var - torch.square(mean) - torch.exp(log_var)))


def scramble(x, size: int, u):
    """Each image's size x size patches in the order of argsort of its uniforms u [B, n]."""
    b, h, w, c = x.shape
    gh, gw = h // size, w // size
    flat = x.reshape(b, gh, size, gw, size, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, -1)
    perm = torch.argsort(u, dim=1, stable=True)
    out = torch.gather(flat, 1, perm[:, :, None].expand(flat.shape))
    return out.reshape(b, gh, gw, size, size, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


# --------------------------------------------------------------------------
# Optimizer: Keras Adam (epsilon 1e-7) as optax writes it, optionally after
# Keras clipnorm (each gradient tensor clipped by its own L2 norm), an update
# skipped whole when a gradient or an update is not finite.
# --------------------------------------------------------------------------


class Adam:
    def __init__(self, params: List[torch.Tensor], lr: float, clip_norm=None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7):
        self.params, self.lr, self.clip_norm = params, lr, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def clip(self, grads):
        if self.clip_norm is None:
            return list(grads)
        out = []
        for g in grads:
            norm = torch.sqrt(torch.sum(g * g))
            out.append(g * (self.clip_norm / torch.clamp_min(norm, self.clip_norm)))
        return out

    @torch.no_grad()
    def step(self, grads) -> List[torch.Tensor]:
        """Applies one update; returns the gradients as Adam took them (clipped)."""
        grads = self.clip(grads)
        t = torch.tensor(float(self.count + 1))
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1), t).item()
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2), t).item()
        mu = [g * (1 - self.b1) + m * self.b1 for g, m in zip(grads, self.mu)]
        nu = [g * g * (1 - self.b2) + v * self.b2 for g, v in zip(grads, self.nu)]
        ups = [-self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps) for m, v in zip(mu, nu)]
        finite = all(bool(torch.isfinite(t).all()) for t in list(grads) + ups)
        if finite:
            self.mu, self.nu, self.count = mu, nu, self.count + 1
            for p, u in zip(self.params, ups):
                p.add_(u)
        return grads
