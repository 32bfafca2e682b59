"""The frozen plain reference of an LG-SPAIR (SPLIT-SPAIR) training step.

The layout of BASELINE config #5: MLP background and local paths
(``dense_bg``, ``dense_local``), the local latent tiled onto every cell's
z_what (``concat_z_what``), its own KL term (``split_z_l``), the patch
scramble as the local view, the training forward through the paste and the
depth-aware composite with N(0, 0.01) noise on the objects' RGB, the
count-prior KL, Keras Adam with clipnorm 1.0. Written from the published
model (SPAIR: Crawford and Pineau, AAAI 2019; SPLIT) in plain float32
PyTorch: the crop and the paste gather their four bilinear taps, every
resize2x -> conv runs as the resize then the conv. Submodule names follow
the flax tree, so the benchmark's weights load by name on both sides.

``draws(cfg, b, gen)`` lists the step's random draws in the order the step
takes them (the scramble's uniforms, then the model's); the render's noise
is a Philox field keyed by a seed the caller hands in.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    Adam, Conv, Dense, ResizeConv, bernoulli_xent, composite, crop, flatten, kl_normal,
    load_weights, mean_sum, paste, render_noise, safe_log, scramble,
)

NOISE_SCALE = 0.01  # the render's noise on the objects' RGB
N_WHERE, N_PASS = 4, 8


def _out(n: int, stride: int) -> int:
    return -(-n // stride)


def grid_hw(image_hw):
    """The cell grid of the backbone's three SAME convs, strides 2, 2, 3."""
    return tuple(_out(_out(_out(n, 2), 2), 3) for n in image_hw)


class EncoderDense(nn.Module):
    def __init__(self, fin: int, latent: int):
        super().__init__()
        self.Dense_0, self.Dense_1 = Dense(fin, 1024), Dense(1024, 500)
        self.Dense_2, self.Dense_3 = Dense(500, latent), Dense(500, latent)

    def forward(self, x, eps):
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(flatten(x)))))
        mean, sig = self.Dense_2(h), F.softplus(self.Dense_3(h))
        return mean + sig * eps, mean, sig


class DecoderDense(nn.Module):
    def __init__(self, latent: int, hw, c: int):
        super().__init__()
        self.hw, self.c = tuple(hw), c
        self.Dense_0, self.Dense_1 = Dense(latent, 500), Dense(500, 1024)
        self.Dense_2 = Dense(1024, hw[0] * hw[1] * c)

    def forward(self, z):
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(z))))
        return torch.sigmoid(self.Dense_2(h)).reshape(-1, *self.hw, self.c)


class ObjEncoder(nn.Module):
    def __init__(self, size: int, c: int, latent: int):
        super().__init__()
        side = _out(_out(size, 2), 2)
        self.Conv_0, self.Conv_1 = Conv(c, 32, 3, 2), Conv(32, 64, 3, 2)
        self.Dense_0 = Dense(side * side * 64, 2 * latent)
        self.Dense_1, self.Dense_2 = Dense(2 * latent, latent), Dense(2 * latent, latent)

    def forward(self, glimpses, eps):
        b, k, h, w, c = glimpses.shape
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(glimpses.reshape(b * k, h, w, c)))))
        hid = F.relu(self.Dense_0(flatten(x)))
        mean, sig = self.Dense_1(hid), F.softplus(self.Dense_2(hid))
        return mean + sig * eps, mean, sig


class ObjDecoder(nn.Module):
    def __init__(self, size: int, c: int, fin: int, latent: int):
        super().__init__()
        self.size, self.c = size, c
        self.Dense_0 = Dense(fin, 2 * latent)
        self.Dense_1 = Dense(2 * latent, (size // 4) ** 2 * 32)
        self.Conv_0 = Conv(32, 64, 3)
        self.Conv_1 = ResizeConv(64, 32, 3, (size // 2, size // 2))
        self.Conv_2 = ResizeConv(32, c + 1, 3, (size, size))

    def forward(self, z):
        s = self.size
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(z)))).reshape(-1, s // 4, s // 4, 32)
        x = self.Conv_2(F.relu(self.Conv_1(F.relu(self.Conv_0(x)))))
        return torch.sigmoid(x[..., :self.c]), torch.sigmoid(x[..., self.c:])


class SpairEncoder(nn.Module):
    """Backbone to a cell grid, then per cell: box, glimpse, what, depth, presence."""

    def __init__(self, c: int, size: int, latent: int, tau: float):
        super().__init__()
        self.size, self.tau = size, tau
        self.conv1, self.conv2 = Conv(c, 128, 4, 2), Conv(128, 128, 4, 2)
        self.conv3 = Conv(128, 128, 4, 3)
        self.z1 = Conv(128, 128, 1, padding="VALID")
        self.z2 = Conv(128, 128, 1, padding="VALID")
        self.z3 = Conv(128, 100, 1, padding="VALID")
        self.where_d1, self.where_d2 = Dense(100, 128), Dense(128, 64)
        self.where_d3 = Dense(64, 2 * N_WHERE + N_PASS)
        self.depth_d1 = Dense(100 + N_PASS + N_WHERE + latent, 64)
        self.depth_d2 = Dense(64, 2 + N_PASS)
        self.pres_d1 = Dense(100 + N_PASS + N_WHERE + latent + 1, 64)
        self.pres_d2 = Dense(64, 1)
        self.obj_encoder = ObjEncoder(size, c, latent)

    def forward(self, x, eps_where, eps_what, eps_depth, u_pres):
        b = x.shape[0]
        h = x
        for conv in (self.conv1, self.conv2, self.conv3, self.z1, self.z2, self.z3):
            h = F.relu(conv(h))
        gh, gw = h.shape[1], h.shape[2]
        feats = h.reshape(b * gh * gw, -1)
        wh = self.where_d3(F.relu(self.where_d2(F.relu(self.where_d1(feats)))))
        where_mean = wh[:, :N_WHERE]
        where_sig = F.softplus(wh[:, N_WHERE:2 * N_WHERE] - 1.0)
        feats_1 = F.relu(wh[:, 2 * N_WHERE:])
        z_where = where_mean + where_sig * eps_where
        z_where_grid = z_where.reshape(b, gh, gw, N_WHERE)
        glimpses = crop(x, z_where_grid, self.size)
        z_what, what_mean, what_sig = self.obj_encoder(glimpses, eps_what)
        program = torch.cat([z_where, z_what], dim=1)
        dh = self.depth_d2(F.relu(self.depth_d1(torch.cat([feats, feats_1, program], dim=1))))
        depth_mean, depth_sig = dh[:, :1], F.softplus(dh[:, 1:2])
        feats_2 = F.relu(dh[:, 2:])
        z_depth = depth_mean + depth_sig * eps_depth
        program = torch.cat([program, z_depth], dim=1)
        logits = self.pres_d2(F.relu(self.pres_d1(torch.cat([feats, feats_2, program], dim=1))))
        logits = torch.clamp(logits, -10.0, 10.0)
        pre = (logits + torch.log(u_pres + 1e-8) - torch.log(1.0 - u_pres + 1e-8)) / self.tau
        grid = lambda v: v.reshape(b, gh, gw, -1)  # noqa: E731
        return dict(z_what=grid(z_what), what_mean=grid(what_mean), what_sig=grid(what_sig),
                    z_where=z_where_grid, where_mean=grid(where_mean), where_sig=grid(where_sig),
                    z_depth=grid(z_depth), depth_mean=grid(depth_mean),
                    depth_sig=grid(depth_sig), z_pres=grid(torch.sigmoid(pre)),
                    logits=grid(logits), pre=grid(pre))


class SpairDecoder(nn.Module):
    def __init__(self, size: int, c: int, fin: int, latent: int):
        super().__init__()
        self.ObjDecoder_0 = ObjDecoder(size, c, fin, latent)


class LGSPAIR(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        h, w, c = cfg["image_size"]
        size, lat, loc, bg = (cfg["object_size"], cfg["latent_size"], cfg["local_latent_size"],
                              cfg["bg_latent_size"])
        self.cfg, self.c = cfg, c
        self.encoder = SpairEncoder(c, size, lat, cfg["tau"])
        self.decoder = SpairDecoder(size, c, lat + loc, lat)
        self.bg_encoder, self.bg_decoder = EncoderDense(h * w * c, bg), DecoderDense(bg, (h, w), c)
        self.x_hat_encoder = EncoderDense(h * w * c, loc)
        self.x_hat_decoder = DecoderDense(loc, (h, w), c)

    def forward(self, images, d: List[torch.Tensor], seed: int):
        """The training forward; ``d`` are the model's draws in order."""
        c = self.c
        x, x_hat = images[..., :c], images[..., c:]
        z_l, l_mean, l_sig = self.x_hat_encoder(x_hat, d[0])
        z_bg, bg_mean, bg_sig = self.bg_encoder(x, d[1])
        enc = self.encoder(x, *d[2:6])
        b, gh, gw = enc["z_what"].shape[:3]
        z_what = torch.cat([enc["z_what"], z_l[:, None, None, :].expand(b, gh, gw, -1)], dim=-1)
        rgb, alpha = self.decoder.ObjDecoder_0(z_what.reshape(b * gh * gw, -1))
        size = self.cfg["object_size"]
        objs = torch.cat([rgb, alpha], dim=-1).reshape(b, gh * gw, size, size, c + 1)
        hw = tuple(images.shape[1:3])
        canvases = paste(objs, enc["z_where"], hw)
        noise = NOISE_SCALE * render_noise(seed, b, gh * gw, c, hw[0], hw[1], images.device)
        depth_w = torch.sigmoid(-enc["z_depth"].reshape(b, -1)) + 0.5
        x_recon = composite(canvases, enc["z_pres"].reshape(b, -1), depth_w,
                            self.bg_decoder(z_bg), noise)
        return dict(enc, x_recon=x_recon, x_hat_recon=self.x_hat_decoder(z_l), l_mean=l_mean,
                    l_sig=l_sig, bg_mean=bg_mean, bg_sig=bg_sig)


def count_kl(z_pres, logits, pre, prior_prob: float, tau: float):
    """The count-prior KL: a geometric prior over counts conditioned on each
    cell's presence in row-major order, a Binary-Concrete KL per cell."""
    b = z_pres.shape[0]
    k = z_pres[0].numel()
    support = torch.arange(k + 1, dtype=torch.float32, device=z_pres.device)
    q = 1.0 - torch.tensor(prior_prob, dtype=torch.float32, device=z_pres.device)
    dist = (1.0 - q) * torch.pow(q, support)
    dist = (dist / torch.clamp_min(dist.sum(), 1e-6))[None, :].expand(b, k + 1)
    so_far = torch.zeros((b, 1), device=z_pres.device)
    pre, logits, pres = pre.reshape(b, k), logits.reshape(b, k), z_pres.reshape(b, k)

    def log_density(y, log_odds):
        yt = y * tau
        return (math.log(tau + 1e-8) - yt + log_odds
                - 2.0 * torch.log(1.0 + torch.exp(-yt + log_odds) + 1e-8))

    total = torch.zeros((b,), device=z_pres.device)
    for i in range(k):
        p_given = torch.clamp_min(support[None, :] - so_far, 0.0) / (k - i)
        p_z = torch.sum(dist * p_given, dim=1, keepdim=True)
        prior_log_odds = safe_log(p_z) - safe_log(1.0 - p_z)
        y = pre[:, i:i + 1]
        kl = log_density(y, logits[:, i:i + 1]) - log_density(y, prior_log_odds)
        sample = (pres[:, i:i + 1] > 0.5).float()
        dist = (sample * p_given + (1.0 - sample) * (1.0 - p_given)) * dist
        dist = dist / torch.clamp_min(dist.sum(dim=1, keepdim=True), 1e-6)
        so_far = so_far + sample
        total = total + kl[:, 0]
    return torch.mean(total)


def anneals(step: int, cfg: Dict):
    """The z_pres prior's probability and the zoom prior's mean at ``step``, in float32."""
    f = torch.float32
    frac = min(torch.tensor(1.0, dtype=f),
               (torch.tensor(step, dtype=f) + 1.0) / torch.tensor(cfg["z_pres_anneal_step"], dtype=f))
    pres = torch.tensor(0.99, dtype=f) * frac
    zoom = (torch.tensor(cfg["prior_z_zoom"], dtype=f)
            + torch.tensor(cfg["prior_z_zoom_start"], dtype=f) * (1.0 - frac))
    return float(pres), float(zoom)


def loss(out, x, x_hat, cfg: Dict, step: int):
    pres_prob, zoom_mean = anneals(step, cfg)
    recon = cfg["reconstruction_weight"] * mean_sum(bernoulli_xent(x, out["x_recon"]))
    z_pres_kl = count_kl(out["z_pres"], out["logits"], out["pre"], pres_prob, cfg["tau"])
    m, s = out["where_mean"][..., :2], out["where_sig"][..., :2]
    zoom_kl = mean_sum(safe_log(torch.tensor(0.5)) - safe_log(s)
                       + (torch.square(s) + torch.square(m - zoom_mean)) / (2.0 * 0.25) - 0.5)
    kl = lambda mean, sig: kl_normal(mean, sig, log=safe_log)  # noqa: E731
    obj = (cfg["z_what_beta"] * kl(out["what_mean"], out["what_sig"])
           + kl(out["depth_mean"], out["depth_sig"])
           + kl(out["where_mean"][..., 2:], out["where_sig"][..., 2:]) + zoom_kl + z_pres_kl)
    return (cfg["z_bg_beta"] * kl(out["bg_mean"], out["bg_sig"])
            + cfg["z_l_beta"] * kl(out["l_mean"], out["l_sig"])
            + mean_sum(bernoulli_xent(x_hat, out["x_hat_recon"])) + recon + cfg["beta"] * obj)


LAYOUT = dict(model="lg_spair", dense_bg=True, dense_local=True, concat_z_what=True,
              split_z_l=True, concat_backbone=False, concat_z_bg=False, augmentation="scramble")


def check_layout(cfg: Dict) -> None:
    wrong = {k: cfg.get(k) for k, v in LAYOUT.items() if cfg.get(k) != v}
    if wrong:
        raise NotImplementedError(f"this reference is config #5's layout; the config has {wrong}")


def draws(cfg: Dict, shape, gen: torch.Generator) -> List[torch.Tensor]:
    """The step's draws for a batch of ``shape`` [B, H, W, C], in order: the
    scramble's uniforms [B, n], then the local and background normals [B, L],
    the cells' z_where [B*K, 4], z_what [B*K, L] and z_depth [B*K, 1] normals
    and their presence uniforms [B*K, 1]. Every draw is per example and
    batch-major."""
    b, h, w = shape[:3]
    p = cfg["patch_size"]
    gh, gw = grid_hw((h, w))
    cells = b * gh * gw
    dev = gen.device
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    return [rand(b, (h // p) * (w // p)), randn(b, cfg["local_latent_size"]),
            randn(b, cfg["bg_latent_size"]), randn(cells, N_WHERE),
            randn(cells, cfg["latent_size"]), randn(cells, 1), rand(cells, 1)]


def model(cfg: Dict, hw=None) -> nn.Module:
    check_layout(cfg)
    return LGSPAIR(cfg)


class Step:
    """The reference training step from given weights: ``run(batch, draws,
    seed)`` takes one step and returns (loss, the gradients Adam took)."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor], device, hw=None):
        self.cfg = cfg
        with torch.device(device):
            self.model = model(cfg)
        load_weights(self.model, weights)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.opt = Adam(self.params, cfg["learning_rate"], clip_norm=1.0)
        self.step = 0

    def run(self, batch, d: List[torch.Tensor], seed: int):
        x = batch.to(torch.float32)
        images = torch.cat([x, scramble(x, self.cfg["patch_size"], d[0])], dim=-1)
        c = x.shape[-1]
        out = self.model(images, d[1:], seed)
        total = loss(out, images[..., :c], images[..., c:], self.cfg, self.step)
        grads = torch.autograd.grad(total, self.params)
        taken = self.opt.step(grads)
        self.step += 1
        return float(total.detach()), taken
