"""SPAIR-family loss (split_vae_tpu/train/losses.py::spair_loss), the lg_spair branch.

spair/trainer.py:136-234 with its annealing schedules; metric keys are the
reference's. Only ``split_z_l=True`` is ported so far.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from split_vae_torch.models.spair import SpairOutput
from split_vae_torch.ops.count_prior import z_pres_count_kl
from split_vae_torch.ops.distributions import (
    bernoulli_xent,
    gaussian_kl_safe,
    gaussian_kl_two_safe,
    mean_sum,
)
from split_vae_torch.train import schedules


def spair_loss(out: SpairOutput, images: torch.Tensor, config, step,
               training: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LG-SPAIR total loss; for test steps the anneals are pinned
    (prior_z_pres_prob = 0.99, prior_z_zoom_mean = config.prior_z_zoom)."""
    if config.model != "lg_spair" or not config.split_z_l:
        raise NotImplementedError("only the lg_spair loss with split_z_l is ported yet")
    c = images.shape[-1] // 2
    x, x_hat = images[..., :c], images[..., c:]

    x_recon_loss = mean_sum(bernoulli_xent(x, out.x_recon))

    if training:
        prior_z_pres_prob = schedules.z_pres_prior_prob(step, config.z_pres_anneal_step)
        prior_z_zoom_mean = schedules.z_zoom_prior_mean(
            step, config.prior_z_zoom, config.prior_z_zoom_start, config.z_pres_anneal_step)
    else:
        prior_z_pres_prob = 0.99
        prior_z_zoom_mean = config.prior_z_zoom

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
    obj_kls = (config.z_what_beta * z_what_kl + z_depth_kl + z_where_kl
               + z_where_zoom_kl + z_pres_kl)

    # spair/trainer.py:190-200 (split_z_l)
    x_hat_recon_loss = mean_sum(bernoulli_xent(x_hat, out.x_hat_recon))
    z_l_kl = gaussian_kl_safe(out.z_l_mean, out.z_l_sig)
    z_bg_kl = gaussian_kl_safe(out.z_bg_mean, out.z_bg_sig)
    total = (config.z_bg_beta * z_bg_kl + config.z_l_beta * z_l_kl + x_hat_recon_loss
             + config.reconstruction_weight * x_recon_loss + config.beta * obj_kls)
    metrics.update({
        "z_bg_kl_loss": z_bg_kl,
        "z_l_kl_loss": z_l_kl,
        "x_hat_recon_loss": x_hat_recon_loss,
    })
    if not training:
        # Reference test-step quirk: the reported z_bg KL uses concat([z_bg, z_l])
        # (spair/trainer.py:266).
        metrics["z_bg_kl_loss"] = gaussian_kl_safe(
            torch.cat([out.z_bg_mean, out.z_l_mean], dim=1),
            torch.cat([out.z_bg_sig, out.z_l_sig], dim=1))
    metrics["total_loss"] = total
    return total, metrics
