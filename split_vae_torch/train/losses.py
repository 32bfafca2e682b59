"""Losses (split_vae_tpu/train/losses.py): the three VAE families and ``spair_loss``.

vae/trainer.py:120-196 and spair/trainer.py:136-234 with its annealing
schedules, one branch a model; metric keys are the reference's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from split_vae_torch.models.spair import SpairOutput
from split_vae_torch.models.vae import GMVaeOutput, LGGMVaeOutput, LGVaeOutput
from split_vae_torch.ops.count_prior import z_pres_count_kl
from split_vae_torch.ops.distributions import (
    bernoulli_xent,
    categorical_kl_uniform,
    discretized_logistic_nll,
    gaussian_kl,
    gaussian_kl_safe,
    gaussian_kl_two,
    gaussian_kl_two_safe,
    mean_sum,
)
from split_vae_torch.train import schedules


def _upcast(out):
    """The model's outputs with every bfloat16 tensor in float32
    (split_vae_tpu/train/losses.py:36-45): logs, KLs and sums over thousands
    of pixels need float32's mantissa. Nothing changes in float32."""
    return type(out)(*(t.float() if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
                       else t for t in out))


def _recon_nll(x: torch.Tensor, mean: torch.Tensor, log_scale: torch.Tensor) -> torch.Tensor:
    """Batch mean of the pixel-summed discretized-logistic NLL (vae/trainer.py:127-128)."""
    return torch.mean(torch.sum(discretized_logistic_nll(x, mean, log_scale), dim=(1, 2, 3)))


def lgvae_loss(out: LGVaeOutput, images: torch.Tensor,
               beta: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """total = x_recon + x_hat_recon + beta * KL(concat z) (vae/trainer.py:120-144)."""
    out = _upcast(out)
    x, x_hat = images[..., :3], images[..., 3:]
    x_recon_loss = _recon_nll(x, out.x_mean, out.x_log_scale)
    x_hat_recon_loss = _recon_nll(x_hat, out.x_hat_mean, out.x_hat_log_scale)
    total_kl = beta * gaussian_kl(torch.cat([out.z_mean_x, out.z_mean_x_hat], dim=1),
                                  torch.cat([out.z_sig_x, out.z_sig_x_hat], dim=1))
    total = x_recon_loss + x_hat_recon_loss + total_kl
    return total, {
        "x_recon_loss": x_recon_loss,
        "x_kl_loss": gaussian_kl(out.z_mean_x, out.z_sig_x),
        "x_hat_recon_loss": x_hat_recon_loss,
        "x_hat_kl_loss": gaussian_kl(out.z_mean_x_hat, out.z_sig_x_hat),
        "total_kl_loss": total_kl,
        "total_loss": total,
    }


def lggmvae_loss(out: LGGMVaeOutput, images: torch.Tensor, beta: float, alpha: float,
                 y_size: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x and x_hat recons + beta * (KL(z_g || the y prior) + KL(z_l || N(0, 1)))
    + alpha * KL(y || uniform) (vae/trainer.py:146-173)."""
    out = _upcast(out)
    x, x_hat = images[..., :3], images[..., 3:]
    x_recon_loss = _recon_nll(x, out.x_mean, out.x_log_scale)
    x_hat_recon_loss = _recon_nll(x_hat, out.x_hat_mean, out.x_hat_log_scale)
    x_kl = gaussian_kl_two(out.z_mean_x, out.z_sig_x, out.z_prior_mean, out.z_prior_sig)
    # The N(0, 1) prior as device tensors: a Python 0.0 and 1.0 would each be
    # copied to the device on every step.
    x_hat_kl = gaussian_kl_two(out.z_mean_x_hat, out.z_sig_x_hat,
                               torch.zeros_like(out.z_mean_x_hat),
                               torch.ones_like(out.z_sig_x_hat))
    y_kl = categorical_kl_uniform(out.y_logits, y_size)
    total = x_recon_loss + x_hat_recon_loss + beta * (x_kl + x_hat_kl) + alpha * y_kl
    return total, {
        "x_recon_loss": x_recon_loss,
        "x_kl_loss": x_kl,
        "x_hat_recon_loss": x_hat_recon_loss,
        "x_hat_kl_loss": x_hat_kl,
        "y_kl_loss": y_kl,
        "total_loss": total,
    }


def gmvae_loss(out: GMVaeOutput, images: torch.Tensor, beta: float, alpha: float,
               y_size: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x recon + beta * KL(z || the y prior) + alpha * KL(y || uniform)
    (vae/trainer.py:175-195)."""
    out = _upcast(out)
    x = images[..., :3]
    x_recon_loss = _recon_nll(x, out.x_mean, out.x_log_scale)
    x_kl = gaussian_kl_two(out.z_mean_x, out.z_sig_x, out.z_prior_mean, out.z_prior_sig)
    y_kl = categorical_kl_uniform(out.y_logits, y_size)
    total = x_recon_loss + beta * x_kl + alpha * y_kl
    return total, {
        "x_recon_loss": x_recon_loss,
        "x_kl_loss": x_kl,
        "y_kl_loss": y_kl,
        "total_loss": total,
    }


def _cat_kl(mean_a, sig_a, mean_b, sig_b) -> torch.Tensor:
    """gaussian_kl_safe of two posteriors concatenated along the last axis."""
    return gaussian_kl_safe(torch.cat([mean_a, mean_b], dim=-1),
                            torch.cat([sig_a, sig_b], dim=-1))


def spair_loss(out: SpairOutput, images: torch.Tensor, config, step,
               training: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SPAIR-family total loss with its anneals; for test steps the anneals are
    pinned (prior_z_pres_prob = 0.99, prior_z_zoom_mean = config.prior_z_zoom,
    beta_t = config.beta)."""
    out = _upcast(out)
    if config.model == "lg_spair":
        c = images.shape[-1] // 2
        x, x_hat = images[..., :c], images[..., c:]
    else:
        x, x_hat = images, None

    x_recon_loss = mean_sum(bernoulli_xent(x, out.x_recon))

    if training:
        prior_z_pres_prob = schedules.z_pres_prior_prob(step, config.z_pres_anneal_step)
        prior_z_zoom_mean = schedules.z_zoom_prior_mean(
            step, config.prior_z_zoom, config.prior_z_zoom_start, config.z_pres_anneal_step)
        beta_t = schedules.beta_warmup(step, config.beta, config.anneal_until)
    else:
        prior_z_pres_prob = 0.99
        prior_z_zoom_mean = config.prior_z_zoom
        beta_t = config.beta

    z_pres_kl = z_pres_count_kl(out.z_pres, out.z_pres_logits, out.z_pres_pre_sigmoid,
                                prior_z_pres_prob, config.tau)
    z_where_zoom_kl = gaussian_kl_two_safe(out.z_where_mean[..., :2],
                                           out.z_where_sigma[..., :2], prior_z_zoom_mean, 0.5)
    z_what_kl = gaussian_kl_safe(out.z_what_mean, out.z_what_sigma)
    z_where_kl = gaussian_kl_safe(out.z_where_mean[..., 2:], out.z_where_sigma[..., 2:])
    z_depth_kl = gaussian_kl_safe(out.z_depth_mean, out.z_depth_sigma)

    metrics = {
        "x_recon_loss": x_recon_loss,
        "z_zoom_kl_loss": z_where_zoom_kl,
        "z_what_kl_loss": z_what_kl,
        "z_where_kl_loss": z_where_kl,
        "z_depth_kl_loss": z_depth_kl,
        "z_pres_kl_loss": z_pres_kl,
    }

    def obj_kls(what_kl):
        return (config.z_what_beta * what_kl + z_depth_kl + z_where_kl + z_where_zoom_kl
                + z_pres_kl)

    recon = config.reconstruction_weight * x_recon_loss
    total = recon + beta_t * obj_kls(z_what_kl)

    # In the two local-path branches the logged z_what KL stays the plain
    # per-cell one; its concat form enters only the total (spair/trainer.py:162).
    if config.model == "lg_spair":
        x_hat_recon_loss = mean_sum(bernoulli_xent(x_hat, out.x_hat_recon))
        z_l_kl = gaussian_kl_safe(out.z_l_mean, out.z_l_sig)
        z_bg_kl = gaussian_kl_safe(out.z_bg_mean, out.z_bg_sig)
        if not config.split_z_l:
            # spair/trainer.py:170-188: the concat forms of the KLs, raw config.beta.
            if config.concat_z_bg:
                z_bg_kl = _cat_kl(out.z_bg_mean, out.z_bg_sig, out.z_l_mean, out.z_l_sig)
            if config.concat_z_what:
                b, gh, gw = out.z_what_mean.shape[:3]
                tiled_m = out.z_l_mean[:, None, None, :].expand(b, gh, gw, -1)
                tiled_s = out.z_l_sig[:, None, None, :].expand(b, gh, gw, -1)
                z_what_kl = _cat_kl(out.z_what_mean, out.z_what_sigma, tiled_m, tiled_s)
            total = (config.z_bg_beta * z_bg_kl + recon + config.beta * obj_kls(z_what_kl)
                     + x_hat_recon_loss)
        else:
            # spair/trainer.py:190-200
            total = (config.z_bg_beta * z_bg_kl + config.z_l_beta * z_l_kl + x_hat_recon_loss
                     + recon + config.beta * obj_kls(z_what_kl))
        if not training:
            # Reference test-step quirk: the reported z_bg KL always uses
            # concat([z_bg, z_l]), whatever concat_z_bg says (spair/trainer.py:266).
            z_bg_kl = _cat_kl(out.z_bg_mean, out.z_bg_sig, out.z_l_mean, out.z_l_sig)
        metrics.update({"z_bg_kl_loss": z_bg_kl, "z_l_kl_loss": z_l_kl,
                        "x_hat_recon_loss": x_hat_recon_loss})
    elif config.model == "lg_glimpse_spair":
        # spair/trainer.py:203-214
        z_bg_kl = gaussian_kl_safe(out.z_bg_mean, out.z_bg_sig)
        z_l_kl = gaussian_kl_safe(out.z_l_mean, out.z_l_sig)
        z_what_concat_kl = _cat_kl(out.z_what_mean, out.z_what_sigma, out.z_l_mean, out.z_l_sig)
        x_hat_recon_loss = mean_sum(bernoulli_xent(out.x_hat.detach(), out.x_hat_recon))
        total = (config.z_bg_beta * z_bg_kl + x_hat_recon_loss + recon
                 + config.beta * obj_kls(z_what_concat_kl))
        metrics.update({"z_bg_kl_loss": z_bg_kl, "z_l_kl_loss": z_l_kl,
                        "x_hat_recon_loss": x_hat_recon_loss})
    elif config.model == "bg_spair":
        # spair/trainer.py:217-224
        z_bg_kl = gaussian_kl_safe(out.z_bg_mean, out.z_bg_sig)
        total = config.z_bg_beta * z_bg_kl + recon + beta_t * obj_kls(z_what_kl)
        metrics["z_bg_kl_loss"] = z_bg_kl

    metrics["total_loss"] = total
    return total, metrics
