"""The frozen plain reference of a glimpse-local SPLIT-SPAIR (LGGlimpseSPAIR)
training step.

SPAIR with an MLP background VAE (``dense_bg``) and, per cell, a second VAE
on the cell's glimpse: the glimpse's 8x8 patches (``patch_size``) scrambled by
one permutation shared by every glimpse of the batch, encoded by a conv head
of its own to a local latent z_l, and decoded back to the scrambled glimpse.
The training forward goes through the paste and the depth-aware composite
with N(0, 0.01) noise on the objects' RGB; the loss is the SPAIR loss with
the KL of z_what and z_l concatenated in z_what's place, the background KL
and the scrambled glimpses' reconstruction; Keras Adam with clipnorm 1.0.
Written in plain float32 PyTorch from the published model (SPAIR: Crawford
and Pineau, AAAI 2019; SPLIT) and LG-SPAIR's reference (``lgspair.py``),
whose layers it shares: the crop and the paste gather their four bilinear
taps, every resize2x -> conv runs as the resize then the conv. Submodule
names follow the flax tree, so the benchmark's weights load by name.

Departures from the SPLIT reference (github.com/51616/split-vae), which
names the model (``spair/main.py --model lg_glimpse_spair``) but lacks its
class:

- ``GlimpseDecoder`` is the JAX package's: the object decoder's layers with
  C outputs (no alpha), a sigmoid;
- one permutation a batch, as the JAX package draws it, and the encoder's
  ``ObjEncoderScramble`` (spair/spair.py:275-338) as the JAX package
  settles it;
- the loss is spair/trainer.py:203-214: the scrambled glimpse is the target
  of its reconstruction with no gradient through it (``x_hat`` detached),
  and the object KLs weigh in at the raw ``beta``;
- ``split_z_l``, ``dense_local``, ``concat_z_what`` and ``z_l_beta`` are
  LG-SPAIR's flags, which this model does not read.

``draws(cfg, shape, gen)`` lists the step's random draws in the order the
port's step takes them; the render's noise is a Philox field keyed by a seed
the caller hands in. The caller runs the step with TF32 off for matrix
products and convolutions (``harness/check.py::reference_steps``, whose
control turns it on).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    Adam, Conv, Dense, ResizeConv, bernoulli_xent, composite, flatten, kl_normal,
    load_weights, mean_sum, paste, render_noise, safe_log, scramble,
)
from .lgspair import (
    N_WHERE, NOISE_SCALE, DecoderDense, EncoderDense, SpairDecoder, SpairEncoder, _out,
    anneals, count_kl, grid_hw,
)


class ObjEncoderScramble(nn.Module):
    """The what head on each glimpse and the local head on its scrambled
    view. Called by ``SpairEncoder`` in ``ObjEncoder``'s place, with the
    draws (u_perm, eps_what, eps_l) for eps: it returns z_what's triple and
    keeps the local one (z_l, its mean and sigma, the scrambled glimpses) in
    ``local``."""

    def __init__(self, size: int, c: int, latent: int, patch: int, local: int):
        super().__init__()
        self.patch = patch
        side = _out(_out(size, 2), 2)
        for prefix, width in (("what", latent), ("local", local)):
            setattr(self, f"{prefix}_c1", Conv(c, 32, 3, 2))
            setattr(self, f"{prefix}_c2", Conv(32, 64, 3, 2))
            setattr(self, f"{prefix}_d1", Dense(side * side * 64, 2 * latent))
            setattr(self, f"{prefix}_mu", Dense(2 * latent, width))
            setattr(self, f"{prefix}_sigma", Dense(2 * latent, width))
        self.local = None

    def head(self, x, prefix: str, eps):
        layer = lambda name: getattr(self, f"{prefix}_{name}")  # noqa: E731
        h = F.relu(layer("c2")(F.relu(layer("c1")(x))))
        h = F.relu(layer("d1")(flatten(h)))
        mean, sig = layer("mu")(h), F.softplus(layer("sigma")(h))
        return mean + sig * eps, mean, sig

    def forward(self, glimpses, eps):
        u_perm, eps_what, eps_l = eps
        b, k, h, w, c = glimpses.shape
        x = glimpses.reshape(b * k, h, w, c)
        # One permutation for every glimpse: the argsort of the draw's row 0.
        x_hat = scramble(x, self.patch, u_perm[:1].expand(b * k, -1))
        self.local = self.head(x_hat, "local", eps_l) + (x_hat.reshape(b, k, h, w, c),)
        return self.head(x, "what", eps_what)


class GlimpseEncoder(SpairEncoder):
    """``SpairEncoder`` with ``ObjEncoderScramble`` as its object encoder."""

    def __init__(self, c: int, size: int, latent: int, tau: float, patch: int, local: int):
        super().__init__(c, size, latent, tau)
        self.obj_encoder = ObjEncoderScramble(size, c, latent, patch, local)

    def forward(self, x, eps_where, u_perm, eps_what, eps_l, eps_depth, u_pres):
        out = super().forward(x, eps_where, (u_perm, eps_what, eps_l), eps_depth, u_pres)
        z_l, l_mean, l_sig, x_hat = self.obj_encoder.local
        b, gh, gw = out["z_what"].shape[:3]
        grid = lambda v: v.reshape(b, gh, gw, -1)  # noqa: E731
        return dict(out, z_l=grid(z_l), l_mean=grid(l_mean), l_sig=grid(l_sig), x_hat=x_hat)


class GlimpseDecoder(nn.Module):
    """z_l -> the scrambled glimpse's reconstruction [B*K, size, size, C], sigmoid."""

    def __init__(self, size: int, c: int, latent: int):
        super().__init__()
        self.size = size
        self.Dense_0 = Dense(latent, 2 * latent)
        self.Dense_1 = Dense(2 * latent, (size // 4) ** 2 * 32)
        self.Conv_0 = Conv(32, 64, 3)
        self.Conv_1 = ResizeConv(64, 32, 3, (size // 2, size // 2))
        self.Conv_2 = ResizeConv(32, c, 3, (size, size))

    def forward(self, z):
        s = self.size
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(z)))).reshape(-1, s // 4, s // 4, 32)
        return torch.sigmoid(self.Conv_2(F.relu(self.Conv_1(F.relu(self.Conv_0(x))))))


class LGGlimpseSPAIR(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        h, w, c = cfg["image_size"]
        size, lat, loc, bg = (cfg["object_size"], cfg["latent_size"], cfg["local_latent_size"],
                              cfg["bg_latent_size"])
        self.cfg, self.c = cfg, c
        self.encoder = GlimpseEncoder(c, size, lat, cfg["tau"], cfg["patch_size"], loc)
        self.decoder = SpairDecoder(size, c, lat, lat)
        self.bg_encoder, self.bg_decoder = EncoderDense(h * w * c, bg), DecoderDense(bg, (h, w), c)
        self.x_hat_decoder = GlimpseDecoder(size, c, loc)

    def forward(self, x, d: List[torch.Tensor], seed: int):
        """The training forward; ``d`` are the step's draws in order."""
        c, size = self.c, self.cfg["object_size"]
        z_bg, bg_mean, bg_sig = self.bg_encoder(x, d[0])
        enc = self.encoder(x, *d[1:7])
        b, gh, gw = enc["z_what"].shape[:3]
        k = gh * gw
        x_hat_recon = self.x_hat_decoder(enc["z_l"].reshape(b * k, -1))
        rgb, alpha = self.decoder.ObjDecoder_0(enc["z_what"].reshape(b * k, -1))
        objs = torch.cat([rgb, alpha], dim=-1).reshape(b, k, size, size, c + 1)
        hw = tuple(x.shape[1:3])
        canvases = paste(objs, enc["z_where"], hw)
        noise = NOISE_SCALE * render_noise(seed, b, k, c, hw[0], hw[1], x.device)
        depth_w = torch.sigmoid(-enc["z_depth"].reshape(b, -1)) + 0.5
        x_recon = composite(canvases, enc["z_pres"].reshape(b, -1), depth_w,
                            self.bg_decoder(z_bg), noise)
        return dict(enc, x_recon=x_recon, x_hat_recon=x_hat_recon.reshape(b, k, size, size, c),
                    bg_mean=bg_mean, bg_sig=bg_sig)


def terms(out, x, cfg: Dict, step: int) -> Dict[str, torch.Tensor]:
    """The loss's terms under the port's metric names, and ``total_loss``."""
    pres_prob, zoom_mean = anneals(step, cfg)
    recon = mean_sum(bernoulli_xent(x, out["x_recon"]))
    z_pres_kl = count_kl(out["z_pres"], out["logits"], out["pre"], pres_prob, cfg["tau"])
    m, s = out["where_mean"][..., :2], out["where_sig"][..., :2]
    zoom_kl = mean_sum(safe_log(torch.tensor(0.5)) - safe_log(s)
                       + (torch.square(s) + torch.square(m - zoom_mean)) / (2.0 * 0.25) - 0.5)
    kl = lambda mean, sig: kl_normal(mean, sig, log=safe_log)  # noqa: E731
    what_kl = kl(out["what_mean"], out["what_sig"])
    where_kl = kl(out["where_mean"][..., 2:], out["where_sig"][..., 2:])
    depth_kl = kl(out["depth_mean"], out["depth_sig"])
    concat_kl = kl(torch.cat([out["what_mean"], out["l_mean"]], dim=-1),
                   torch.cat([out["what_sig"], out["l_sig"]], dim=-1))
    bg_kl = kl(out["bg_mean"], out["bg_sig"])
    x_hat_recon = mean_sum(bernoulli_xent(out["x_hat"].detach(), out["x_hat_recon"]))
    obj = cfg["z_what_beta"] * concat_kl + depth_kl + where_kl + zoom_kl + z_pres_kl
    total = (cfg["z_bg_beta"] * bg_kl + x_hat_recon + cfg["reconstruction_weight"] * recon
             + cfg["beta"] * obj)
    return {"x_recon_loss": recon, "z_zoom_kl_loss": zoom_kl, "z_what_kl_loss": what_kl,
            "z_where_kl_loss": where_kl, "z_depth_kl_loss": depth_kl,
            "z_pres_kl_loss": z_pres_kl, "z_bg_kl_loss": bg_kl,
            "z_l_kl_loss": kl(out["l_mean"], out["l_sig"]), "x_hat_recon_loss": x_hat_recon,
            "total_loss": total}


LAYOUT = dict(model="lg_glimpse_spair", dense_bg=True)


def check_layout(cfg: Dict) -> None:
    wrong = {k: cfg.get(k) for k, v in LAYOUT.items() if cfg.get(k) != v}
    if wrong:
        raise NotImplementedError(f"this reference is LGGlimpseSPAIR with a dense background; "
                                  f"the config has {wrong}")


def draws(cfg: Dict, shape, gen: torch.Generator) -> List[torch.Tensor]:
    """The step's draws for a batch of ``shape`` [B, H, W, C], in order: the
    background's normals [B, bg], the cells' z_where normals [B*K, 4], the
    patch permutation's float64 uniforms [B, n] (its argsort of row 0 orders
    every glimpse's n patches), the z_what [B*K, L] and z_l [B*K, local]
    normals, the z_depth normals [B*K, 1] and the presence uniforms [B*K, 1].
    Every draw is batch-major: the first half of each is half the batch's,
    the permutation's too."""
    b, h, w = shape[:3]
    n = (cfg["object_size"] // cfg["patch_size"]) ** 2
    gh, gw = grid_hw((h, w))
    cells = b * gh * gw
    dev = gen.device
    rand = lambda *s, dtype=torch.float32: torch.rand(  # noqa: E731
        s, generator=gen, device=dev, dtype=dtype)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    return [randn(b, cfg["bg_latent_size"]), randn(cells, N_WHERE),
            rand(b, n, dtype=torch.float64), randn(cells, cfg["latent_size"]),
            randn(cells, cfg["local_latent_size"]), randn(cells, 1), rand(cells, 1)]


def model(cfg: Dict, hw=None) -> nn.Module:
    check_layout(cfg)
    return LGGlimpseSPAIR(cfg)


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
        total = terms(self.model(x, d, seed), x, self.cfg, self.step)["total_loss"]
        grads = torch.autograd.grad(total, self.params)
        taken = self.opt.step(grads)
        self.step += 1
        return float(total.detach()), taken
