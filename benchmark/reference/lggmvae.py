"""The frozen plain reference of an LGGMVae (SPLIT-GMVAE) training step.

BASELINE config #4's model (reference ``vae/model.py:48-79,116-140``,
``vae/model.py:221-275``): the global path is a Gaussian-mixture encoder, an
ELU conv stack (128 filters, k 6/6/4, stride 2) into a y block (Dense 1024,
dropout 0.2, Dense 128, the y logits), a Gumbel-softmax cluster sample y at
temperature tau, the y-conditional prior of z (mean and softplus sigma of
y) and the z head elu(e1(dropout 0.2 of the conv features)) +
elu(h_top_dense(y)) to a mean and a softplus sigma. The local path, both
decoders and the discretized logistic are ``reference/lgvae.py``'s. The loss
(``vae/trainer.py:146-173``): the two reconstructions' NLL, plus beta times
KL(z_g || the y prior) + KL(z_l || N(0, 1)), plus alpha times
KL(softmax(y logits) || uniform). Keras Adam without clipping at the
staircase rate lr * 0.4^floor(count / 1e6) (``vae/main.py:67-72``). Plain
float32 PyTorch; submodule names follow the flax tree. TF32 is off for its
matrix products and convolutions: ``harness/check.py::reference_steps`` sets
it before building a ``Step`` (and on for its TF32 control), as for the
other references.

Departures from the published description, each on no number the check
reads:

- the model builds only the two dropouts it applies (the published one
  builds five more and never calls them);
- the dropout keep masks and the Gumbel uniforms come in as tensors
  (``draws``), one stream in the order below, where TensorFlow draws them
  inside its layers.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from .common import Adam, Conv, Dense, flatten, load_weights, scramble
from .lgvae import ConvDecoder, ConvEncoder, logistic_nll

DROPOUT = 0.2
Y_HIDDEN = 1024  # the y block's first Dense


def dropout(x, keep):
    """Inverted dropout at ``DROPOUT`` with the keep mask given."""
    return x * keep.to(x.dtype) / (1.0 - DROPOUT)


class GMEncoder(nn.Module):
    def __init__(self, hw, latent: int, y_size: int, tau: float):
        super().__init__()
        self.tau = tau
        self.h_conv1, self.h_conv2 = Conv(3, 128, 6, 2), Conv(128, 128, 6, 2)
        self.h_conv3 = Conv(128, 128, 4, 2)
        flat = math.ceil(hw[0] / 8) * math.ceil(hw[1] / 8) * 128
        self.y_dense1, self.y_dense2 = Dense(flat, Y_HIDDEN), Dense(Y_HIDDEN, 128)
        self.y_head = Dense(128, y_size)
        self.h_top_dense = Dense(y_size, 512)
        self.z_prior_mean_head, self.z_prior_sig_head = Dense(y_size, latent), Dense(y_size, latent)
        self.e1 = Dense(flat, 512)
        self.z_mean_head, self.z_sig_head = Dense(512, latent), Dense(512, latent)

    def forward(self, x, u, eps, keep_y, keep_h):
        for conv in (self.h_conv1, self.h_conv2, self.h_conv3):
            x = F.elu(conv(x))
        h = flatten(x)
        y_hidden = dropout(F.elu(self.y_dense1(h)), keep_y)
        y_logits = self.y_head(F.elu(self.y_dense2(y_hidden)))
        # the published sampler: softmax((logits - log(-log U)) / tau)
        y = torch.softmax((y_logits - torch.log(-torch.log(u))) / self.tau, dim=-1)
        prior_mean, prior_sig = self.z_prior_mean_head(y), F.softplus(self.z_prior_sig_head(y))
        h = F.elu(self.e1(dropout(h, keep_h))) + F.elu(self.h_top_dense(y))
        mean, sig = self.z_mean_head(h), F.softplus(self.z_sig_head(h))
        return mean + sig * eps, mean, sig, y_logits, prior_mean, prior_sig


class LGGMVae(nn.Module):
    def __init__(self, cfg: Dict, hw):
        super().__init__()
        g, loc = cfg["global_latent_dims"], cfg["local_latent_dims"]
        self.encoder_x = GMEncoder(hw, g, cfg["y_size"], cfg["tau"])
        self.encoder_x_hat = ConvEncoder(hw, loc)
        self.decoder_x, self.decoder_x_hat = ConvDecoder(g + loc, hw), ConvDecoder(loc, hw)


def kl_two(mean1, sig1, mean2, sig2):
    """KL(N(mean1, sig1^2) || N(mean2, sig2^2)) summed over all but the batch,
    batch-meaned."""
    kl = (torch.log(sig2) - torch.log(sig1)
          + (torch.square(sig1) + torch.square(mean1 - mean2)) / (2.0 * torch.square(sig2)) - 0.5)
    return torch.mean(torch.sum(kl.reshape(kl.shape[0], -1), dim=1))


def kl_uniform(logits, k: int):
    """KL(softmax(logits) || uniform over k), batch-meaned, with the published 1e-8."""
    p = torch.softmax(logits, dim=-1)
    return torch.mean(torch.sum(p * (torch.log(p + 1e-8) - math.log(1.0 / k)), dim=-1))


def terms(model: LGGMVae, images, d: List[torch.Tensor], cfg: Dict) -> Dict[str, torch.Tensor]:
    """The loss and its terms under the trainer's names; ``d`` is the model's
    draws: the Gumbel uniforms, the global and local normals, the two keep masks."""
    x, x_hat = images[..., :3], images[..., 3:]
    z, mean, sig, y_logits, prior_mean, prior_sig = model.encoder_x(x, d[0], d[1], d[3], d[4])
    zl, mean_l, sig_l = model.encoder_x_hat(x_hat, d[2])
    xm, xs = model.decoder_x(torch.cat([z, zl], dim=1))
    hm, hs = model.decoder_x_hat(zl)
    recon = lambda t, m, s: torch.mean(torch.sum(logistic_nll(t, m, s), dim=(1, 2, 3)))  # noqa
    out = {"x_recon_loss": recon(x, xm, xs),
           "x_kl_loss": kl_two(mean, sig, prior_mean, prior_sig),
           "x_hat_recon_loss": recon(x_hat, hm, hs),
           "x_hat_kl_loss": kl_two(mean_l, sig_l, torch.zeros_like(mean_l),
                                   torch.ones_like(sig_l)),
           "y_kl_loss": kl_uniform(y_logits, cfg["y_size"])}
    out["total_loss"] = (out["x_recon_loss"] + out["x_hat_recon_loss"]
                         + cfg["beta"] * (out["x_kl_loss"] + out["x_hat_kl_loss"])
                         + cfg["alpha"] * out["y_kl_loss"])
    return out


LAYOUT = dict(model="lggmvae", augmentation="scramble")


def draws(cfg: Dict, shape, gen: torch.Generator) -> List[torch.Tensor]:
    """The step's draws for a batch of ``shape`` [B, H, W, C], in order: the
    scramble's uniforms [B, n], the Gumbel uniforms [B, y_size], the global
    and local normals [B, L], then the keep masks of the y block [B, 1024]
    and of the conv features [B, flat] (bool). Every draw is per example."""
    (b, h, w), p, dev = shape[:3], cfg["patch_size"], gen.device
    flat = math.ceil(h / 8) * math.ceil(w / 8) * 128
    return [torch.rand((b, (h // p) * (w // p)), generator=gen, device=dev),
            torch.rand((b, cfg["y_size"]), generator=gen, device=dev),
            torch.randn((b, cfg["global_latent_dims"]), generator=gen, device=dev),
            torch.randn((b, cfg["local_latent_dims"]), generator=gen, device=dev),
            torch.rand((b, Y_HIDDEN), generator=gen, device=dev) < 1.0 - DROPOUT,
            torch.rand((b, flat), generator=gen, device=dev) < 1.0 - DROPOUT]


def model(cfg: Dict, hw) -> nn.Module:
    wrong = {k: cfg.get(k) for k, v in LAYOUT.items() if cfg.get(k) != v}
    if wrong:
        raise NotImplementedError(f"this reference is config #4's layout; the config has {wrong}")
    return LGGMVae(cfg, hw)


def images_of(batch, cfg: Dict, u):
    """uint8 [B, H, W, 3] -> [x | scramble(x)] in [-1, 1]."""
    x = batch.to(torch.float32) / 255.0 * 2.0 - 1.0
    return torch.cat([x, scramble(x, cfg["patch_size"], u)], dim=-1)


class Step:
    """The reference training step from given weights: ``run(batch, draws,
    seed)`` takes one step and returns (loss, the gradients Adam took); the
    seed is unused (no render)."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor], device, hw):
        self.cfg = cfg
        with torch.device(device):
            self.model = model(cfg, hw)
        load_weights(self.model, weights)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.opt = Adam(self.params, cfg["learning_rate"])

    def run(self, batch, d: List[torch.Tensor], seed: int):
        images = images_of(batch, self.cfg, d[0])
        total = terms(self.model, images, d[1:], self.cfg)["total_loss"]
        grads = torch.autograd.grad(total, self.params)
        self.opt.lr = self.cfg["learning_rate"] * 0.4 ** (self.opt.count // 1_000_000)
        return float(total.detach()), self.opt.step(grads)
