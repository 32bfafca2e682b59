"""Numerical primitives: distributions, STN crop and paste, patch scramble, count prior."""

from split_vae_torch.ops.count_prior import z_pres_count_kl
from split_vae_torch.ops.distributions import (
    bernoulli_xent,
    categorical_kl_uniform,
    concrete_binary_pre_sigmoid_sample,
    concrete_binary_sample_kl,
    discretized_logistic_nll,
    gaussian_kl,
    gaussian_kl_safe,
    gaussian_kl_two,
    gaussian_kl_two_safe,
    gumbel_softmax,
    mean_sum,
    reparameterize,
    safe_log,
)
from split_vae_torch.ops.patches import (
    augment_batch,
    batched_scramble,
    gaussian_blur,
    high_low_pass,
    mix_scramble,
    patch_scramble,
)
from split_vae_torch.ops.stn import stn_crop, stn_paste, zwhere_to_bbox, zwhere_to_params
