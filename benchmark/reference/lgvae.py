"""The frozen plain reference of an LGVae (SPLIT-VAE) training step.

BASELINE config #2's model: two conv encoders (the image and its patch
scramble), a decoder of concat(z_g, z_l) to the image and one of z_l to the
scramble, each a Dense, convs and bilinear x2 resizes to the mean and log
scale of a discretized logistic; the loss is the two reconstructions' NLL
plus beta times the KL of both latents; Keras Adam without clipping. Plain
float32 PyTorch from the published model; the last resize -> conv runs as
the resize then the conv. Submodule names follow the flax tree.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from .common import Adam, Conv, Dense, ResizeConv, flatten, kl_normal, load_weights, \
    resize_bilinear, scramble


class ConvEncoder(nn.Module):
    def __init__(self, hw, latent: int):
        super().__init__()
        self.Conv_0, self.Conv_1 = Conv(3, 32, 6, 2), Conv(32, 64, 6, 2)
        self.Conv_2 = Conv(64, 128, 4, 2)
        flat = math.ceil(hw[0] / 8) * math.ceil(hw[1] / 8) * 128
        self.Dense_0, self.Dense_1 = Dense(flat, latent), Dense(flat, latent)

    def forward(self, x, eps):
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.relu(conv(x))
        x = flatten(x)
        mean, sig = self.Dense_0(x), F.softplus(self.Dense_1(x))
        return mean + sig * eps, mean, sig


class ConvDecoder(nn.Module):
    def __init__(self, fin: int, hw):
        super().__init__()
        self.hw = tuple(hw)
        h, w = hw
        self.Dense_0 = Dense(fin, h // 8 * (w // 8) * 128)
        self.Conv_0, self.Conv_1 = Conv(128, 128, 4), Conv(128, 64, 4)
        self.Conv_2 = Conv(64, 32, 6)
        self.Conv_3 = ResizeConv(32, 6, 6, (h, w))

    def forward(self, z):
        h, w = self.hw
        x = F.relu(self.Dense_0(z)).reshape(-1, h // 8, w // 8, 128)
        x = resize_bilinear(F.relu(self.Conv_0(x)), h // 4, w // 4)
        x = resize_bilinear(F.relu(self.Conv_1(x)), h // 2, w // 2)
        x = self.Conv_3(F.relu(self.Conv_2(x)))
        return x[..., :3], x[..., 3:]


class LGVae(nn.Module):
    def __init__(self, cfg: Dict, hw):
        super().__init__()
        g, loc = cfg["global_latent_dims"], cfg["local_latent_dims"]
        self.encoder_x, self.encoder_x_hat = ConvEncoder(hw, g), ConvEncoder(hw, loc)
        self.decoder_x, self.decoder_x_hat = ConvDecoder(g + loc, hw), ConvDecoder(loc, hw)


def logistic_nll(x, mean, log_scales):
    """Discretized logistic NLL over 1/255-wide bins, one-sided at the edges
    (|x| > 0.999), the density at the bin's centre where the bin's mass is
    1e-5 or less (PixelCNN++)."""
    centered = x - mean
    inv = torch.exp(-log_scales)
    plus, minus = inv * (centered + 1.0 / 255.0), inv * (centered - 1.0 / 255.0)
    delta = torch.sigmoid(plus) - torch.sigmoid(minus)
    mid = inv * centered
    log_pdf_mid = mid - log_scales - 2.0 * F.softplus(mid)
    log_prob = torch.where(
        x < -0.999, plus - F.softplus(plus),
        torch.where(x > 0.999, -F.softplus(minus),
                    torch.where(delta > 1e-5, torch.log(torch.clamp_min(delta, 1e-12)),
                                log_pdf_mid - math.log(127.5))))
    return -log_prob


def loss(model: LGVae, images, d: List[torch.Tensor], cfg: Dict):
    x, x_hat = images[..., :3], images[..., 3:]
    z, mean, sig = model.encoder_x(x, d[0])
    zl, mean_l, sig_l = model.encoder_x_hat(x_hat, d[1])
    xm, xs = model.decoder_x(torch.cat([z, zl], dim=1))
    hm, hs = model.decoder_x_hat(zl)
    recon = lambda t, m, s: torch.mean(torch.sum(logistic_nll(t, m, s), dim=(1, 2, 3)))  # noqa
    kl = cfg["beta"] * kl_normal(torch.cat([mean, mean_l], 1), torch.cat([sig, sig_l], 1))
    return recon(x, xm, xs) + recon(x_hat, hm, hs) + kl


LAYOUT = dict(model="lgvae", augmentation="scramble")


def draws(cfg: Dict, shape, gen: torch.Generator) -> List[torch.Tensor]:
    """The step's draws for a batch of ``shape`` [B, H, W, C], in order: the
    scramble's uniforms [B, n], then the global and local normals [B, L].
    Every draw is per example."""
    (b, h, w), p, dev = shape[:3], cfg["patch_size"], gen.device
    return [torch.rand((b, (h // p) * (w // p)), generator=gen, device=dev),
            torch.randn((b, cfg["global_latent_dims"]), generator=gen, device=dev),
            torch.randn((b, cfg["local_latent_dims"]), generator=gen, device=dev)]


def model(cfg: Dict, hw) -> nn.Module:
    wrong = {k: cfg.get(k) for k, v in LAYOUT.items() if cfg.get(k) != v}
    if wrong:
        raise NotImplementedError(f"this reference is config #2's layout; the config has {wrong}")
    return LGVae(cfg, hw)


class Step:
    """The reference training step from given weights: ``run(batch, draws,
    seed)`` takes one step and returns (loss, the gradients Adam took)."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor], device, hw):
        self.cfg = cfg
        with torch.device(device):
            self.model = model(cfg, hw)
        load_weights(self.model, weights)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.opt = Adam(self.params, cfg["learning_rate"])

    def run(self, batch, d: List[torch.Tensor], seed: int):
        x = batch.to(torch.float32) / 255.0 * 2.0 - 1.0
        images = torch.cat([x, scramble(x, self.cfg["patch_size"], d[0])], dim=-1)
        total = loss(self.model, images, d[1:], self.cfg)
        grads = torch.autograd.grad(total, self.params)
        return float(total.detach()), self.opt.step(grads)
