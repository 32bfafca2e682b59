"""SPAIR building blocks (split_vae_tpu/nn/spair_nets.py): encoders, object nets, renderer.

Behavioural contract: spair/spair.py:110-579 as the JAX package implements
it. Submodules carry the flax tree's names (``Dense_0``, ``Conv_1``,
``ObjDecoder_0``, ``where_d1``...) so parameters convert by name. Every
stochastic draw comes from a ``Noise`` in the JAX package's call order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from split_vae_torch.core import tracing
from split_vae_torch.core.noise import Noise
from split_vae_torch.kernels import render as render_kernels
from split_vae_torch.kernels import render_windowed as windowed_kernels
from split_vae_torch.nn.common import Conv, Dense, flatten
from split_vae_torch.nn.pixel_shuffle import Resize2xConv
from split_vae_torch.ops.distributions import (
    as_like,
    concrete_binary_pre_sigmoid_sample,
    reparameterize,
)
from split_vae_torch.ops.stn import paste_sample_coords, stn_crop, stn_paste


def _conv_out(n: int, stride: int) -> int:
    return -(-n // stride)  # SAME padding: ceil(n / stride)


def _encode_image(convs, dense_mean, dense_sig, x: torch.Tensor, noise: Noise):
    """Three stride-2 convs, flatten, mean and softplus sigma heads, one sample."""
    for conv in convs:
        x = F.relu(conv(x))
    x = flatten(x)
    z_mean = dense_mean(x)
    z_sig = F.softplus(dense_sig(x))
    return reparameterize(z_mean, z_sig, noise.normal_like(z_sig, per_example=True)), z_mean, z_sig


def _decode_image(dense, conv, up1, up2, up3, z: torch.Tensor, image_hw) -> torch.Tensor:
    """Dense to an [h/8, w/8, 128] map, a conv, three 2x resize+convs to a sigmoid image.

    Reference quirk preserved: the 32-filter conv before the last one has a
    sigmoid activation (spair/spair.py:168).
    """
    h, w = image_hw
    x = F.relu(dense(z)).reshape(-1, h // 8, w // 8, 128)
    x = F.relu(conv(x))
    x = F.relu(up1(x))
    x = torch.sigmoid(up2(x))
    return torch.sigmoid(up3(x))


def _encoded_features(image_hw) -> int:
    h, w = image_hw
    for _ in range(3):
        h, w = _conv_out(h, 2), _conv_out(w, 2)
    return h * w * 128


class ImageEncoder(nn.Module):
    """Conv VAE encoder for backgrounds and the local path (spair/spair.py:110-133)."""

    def __init__(self, image_hw: Tuple[int, int], num_channel: int, latent_size: int,
                 device=None, dtype=None):
        super().__init__()
        self.Conv_0 = Conv(num_channel, 32, (3, 3), stride=2, device=device, dtype=dtype)
        self.Conv_1 = Conv(32, 64, (3, 3), stride=2, device=device, dtype=dtype)
        self.Conv_2 = Conv(64, 128, (3, 3), stride=2, device=device, dtype=dtype)
        self.Dense_0 = Dense(_encoded_features(image_hw), latent_size, device, dtype=dtype)
        self.Dense_1 = Dense(_encoded_features(image_hw), latent_size, device, dtype=dtype)

    def forward(self, x: torch.Tensor, noise: Noise):
        return _encode_image((self.Conv_0, self.Conv_1, self.Conv_2), self.Dense_0,
                             self.Dense_1, x, noise)


class ImageDecoder(nn.Module):
    """Conv decoder to a sigmoid image (spair/spair.py:157-182)."""

    def __init__(self, latent_size: int, image_hw: Tuple[int, int], num_channel: int = 3,
                 device=None, dtype=None):
        super().__init__()
        self.image_hw = tuple(image_hw)
        h, w = image_hw
        self.Dense_0 = Dense(latent_size, h // 8 * (w // 8) * 128, device, dtype=dtype)
        self.Conv_0 = Conv(128, 128, (3, 3), device=device, dtype=dtype)
        self.Conv_1 = Resize2xConv(128, 64, (h // 4, w // 4), device, dtype=dtype)
        self.Conv_2 = Resize2xConv(64, 32, (h // 2, w // 2), device, dtype=dtype)
        self.Conv_3 = Resize2xConv(32, num_channel, (h, w), device, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return _decode_image(self.Dense_0, self.Conv_0, self.Conv_1, self.Conv_2, self.Conv_3,
                             z, self.image_hw)


class BackgroundModel(nn.Module):
    """Background VAE in one module (spair/spair.py:205-244): the conv encoder
    and decoder above under one flax scope, so the decoder's layers are
    ``Dense_2`` and ``Conv_3`` .. ``Conv_6``."""

    def __init__(self, image_hw: Tuple[int, int], bg_latent_size: int, num_channel: int = 3,
                 device=None, dtype=None):
        super().__init__()
        self.image_hw = tuple(image_hw)
        h, w = image_hw
        self.Conv_0 = Conv(num_channel, 32, (3, 3), stride=2, device=device, dtype=dtype)
        self.Conv_1 = Conv(32, 64, (3, 3), stride=2, device=device, dtype=dtype)
        self.Conv_2 = Conv(64, 128, (3, 3), stride=2, device=device, dtype=dtype)
        self.Dense_0 = Dense(_encoded_features(image_hw), bg_latent_size, device, dtype=dtype)
        self.Dense_1 = Dense(_encoded_features(image_hw), bg_latent_size, device, dtype=dtype)
        self.Dense_2 = Dense(bg_latent_size, h // 8 * (w // 8) * 128, device, dtype=dtype)
        self.Conv_3 = Conv(128, 128, (3, 3), device=device, dtype=dtype)
        self.Conv_4 = Resize2xConv(128, 64, (h // 4, w // 4), device, dtype=dtype)
        self.Conv_5 = Resize2xConv(64, 32, (h // 2, w // 2), device, dtype=dtype)
        self.Conv_6 = Resize2xConv(32, num_channel, (h, w), device, dtype=dtype)

    def forward(self, x: torch.Tensor, noise: Noise):
        z, z_mean, z_sig = _encode_image((self.Conv_0, self.Conv_1, self.Conv_2), self.Dense_0,
                                         self.Dense_1, x, noise)
        bg = _decode_image(self.Dense_2, self.Conv_3, self.Conv_4, self.Conv_5, self.Conv_6, z,
                           self.image_hw)
        return bg, z, z_mean, z_sig


class ImageEncoderDense(nn.Module):
    """MLP VAE encoder 1024 -> 500 (spair/spair.py:135-154); flattens the NHWC image."""

    def __init__(self, in_features: int, latent_size: int, device=None, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, 1024, device, dtype=dtype)
        self.Dense_1 = Dense(1024, 500, device, dtype=dtype)
        self.Dense_2 = Dense(500, latent_size, device, dtype=dtype)
        self.Dense_3 = Dense(500, latent_size, device, dtype=dtype)

    def forward(self, x: torch.Tensor, noise: Noise):
        x = F.relu(self.Dense_0(flatten(x)))
        x = F.relu(self.Dense_1(x))
        z_mean = self.Dense_2(x)
        z_sig = F.softplus(self.Dense_3(x))
        z = reparameterize(z_mean, z_sig, noise.normal_like(z_sig, per_example=True))
        return z, z_mean, z_sig


class ImageDecoderDense(nn.Module):
    """MLP decoder 500 -> 1024 -> H*W*C sigmoid (spair/spair.py:185-202)."""

    def __init__(self, latent_size: int, image_hw: Tuple[int, int], num_channel: int = 3,
                 device=None, dtype=None):
        super().__init__()
        self.image_hw = tuple(image_hw)
        self.num_channel = num_channel
        h, w = image_hw
        self.Dense_0 = Dense(latent_size, 500, device, dtype=dtype)
        self.Dense_1 = Dense(500, 1024, device, dtype=dtype)
        self.Dense_2 = Dense(1024, h * w * num_channel, device, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Dense_0(z))
        x = F.relu(self.Dense_1(x))
        x = torch.sigmoid(self.Dense_2(x))
        return x.reshape(-1, *self.image_hw, self.num_channel)


class ObjEncoder(nn.Module):
    """Per-glimpse encoder -> z_what on [B, K, os, os, C] (spair/spair.py:246-273)."""

    def __init__(self, object_size: int, num_channel: int, latent_size: int, device=None,
                 dtype=None):
        super().__init__()
        self.Conv_0 = Conv(num_channel, 32, (3, 3), stride=2, device=device, dtype=dtype)
        self.Conv_1 = Conv(32, 64, (3, 3), stride=2, device=device, dtype=dtype)
        side = _conv_out(_conv_out(object_size, 2), 2)
        self.Dense_0 = Dense(side * side * 64, latent_size * 2, device, dtype=dtype)
        self.Dense_1 = Dense(latent_size * 2, latent_size, device, dtype=dtype)
        self.Dense_2 = Dense(latent_size * 2, latent_size, device, dtype=dtype)

    def forward(self, glimpses: torch.Tensor, noise: Noise):
        b, k, gh, gw, c = glimpses.shape
        x = glimpses.reshape(b * k, gh, gw, c)
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        hdn = F.relu(self.Dense_0(flatten(x)))
        z_mean = self.Dense_1(hdn)
        z_sig = F.softplus(self.Dense_2(hdn))
        z = reparameterize(z_mean, z_sig, noise.normal_like(z_sig, per_example=True))
        return z, z_mean, z_sig


class ObjEncoderScramble(nn.Module):
    """Per-glimpse encoder that also gives a per-glimpse local latent from a
    patch-scrambled view of each glimpse (spair/spair.py:275-338, as the JAX
    package settles it): one patch permutation shared by all glimpses of the
    batch (``Noise.batch_permutation``, a static draw, so the step is
    graphed), and the reassembled scrambled glimpse returned as the x_hat
    target. The draws keep the JAX package's order: the permutation, z_what's
    normals, z_l's. The span ``forward.glimpse_local`` holds the scramble and
    the local head (and the draw of z_what's normals, which falls between
    them), not the what head, which ``ObjEncoder`` runs too; the counter
    ``glimpse.scramble`` counts the scrambles.
    """

    def __init__(self, object_size: int, num_channel: int, latent_size: int, patch_size: int,
                 local_latent_size: int, device=None, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        side = _conv_out(_conv_out(object_size, 2), 2)
        dd = dict(device=device, dtype=dtype)
        for prefix, latent in (("what", latent_size), ("local", local_latent_size)):
            setattr(self, f"{prefix}_c1", Conv(num_channel, 32, (3, 3), stride=2, **dd))
            setattr(self, f"{prefix}_c2", Conv(32, 64, (3, 3), stride=2, **dd))
            setattr(self, f"{prefix}_d1", Dense(side * side * 64, latent_size * 2, **dd))
            setattr(self, f"{prefix}_mu", Dense(latent_size * 2, latent, **dd))
            setattr(self, f"{prefix}_sigma", Dense(latent_size * 2, latent, **dd))

    def _vae_head(self, v: torch.Tensor, prefix: str):
        v = F.relu(getattr(self, f"{prefix}_c1")(v))
        v = F.relu(getattr(self, f"{prefix}_c2")(v))
        v = F.relu(getattr(self, f"{prefix}_d1")(flatten(v)))
        return (getattr(self, f"{prefix}_mu")(v),
                F.softplus(getattr(self, f"{prefix}_sigma")(v)))

    def forward(self, glimpses: torch.Tensor, noise: Noise):
        b, k, gh, gw, c = glimpses.shape
        x = glimpses.reshape(b * k, gh, gw, c)
        p = self.patch_size
        nh, nw = gh // p, gw // p
        z_what_mean, z_what_sigma = self._vae_head(x, "what")
        tracing.count("glimpse.scramble")
        with tracing.span("forward.glimpse_local"):
            perm = noise.batch_permutation(nh * nw, b)  # one for the batch, every rank's
            eps_what = noise.normal_like(z_what_sigma, per_example=True)
            patches = x.reshape(b * k, nh, p, nw, p, c).permute(0, 1, 3, 2, 4, 5)
            patches = torch.index_select(patches.reshape(b * k, nh * nw, p, p, c), 1, perm)
            x_hat = patches.reshape(b * k, nh, nw, p, p, c).permute(0, 1, 3, 2, 4, 5)
            x_hat = x_hat.reshape(b * k, gh, gw, c)
            z_l_mean, z_l_sig = self._vae_head(x_hat, "local")
            z_l = reparameterize(z_l_mean, z_l_sig, noise.normal_like(z_l_sig, per_example=True))
        z_what = reparameterize(z_what_mean, z_what_sigma, eps_what)
        return (z_what, z_what_mean, z_what_sigma, z_l, z_l_mean, z_l_sig,
                x_hat.reshape(b, k, gh, gw, c))


class GlimpseDecoder(nn.Module):
    """z_l -> the scrambled glimpse's reconstruction [B*K, os, os, C], sigmoid."""

    def __init__(self, object_size: int, num_channel: int, latent_size: int, device=None,
                 dtype=None):
        super().__init__()
        self.object_size = object_size
        os_ = object_size
        self.Dense_0 = Dense(latent_size, latent_size * 2, device, dtype=dtype)
        self.Dense_1 = Dense(latent_size * 2, os_ // 4 * (os_ // 4) * 32, device, dtype=dtype)
        self.Conv_0 = Conv(32, 64, (3, 3), device=device, dtype=dtype)
        self.Conv_1 = Resize2xConv(64, 32, (os_ // 2, os_ // 2), device, dtype=dtype)
        self.Conv_2 = Resize2xConv(32, num_channel, (os_, os_), device, dtype=dtype)

    def forward(self, z_l: torch.Tensor) -> torch.Tensor:
        os_ = self.object_size
        x = F.relu(self.Dense_0(z_l))
        x = F.relu(self.Dense_1(x))
        x = x.reshape(-1, os_ // 4, os_ // 4, 32)
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        return torch.sigmoid(self.Conv_2(x))


class ObjDecoder(nn.Module):
    """z_what -> RGB object + alpha, both sigmoid (spair/spair.py:341-366)."""

    def __init__(self, object_size: int, num_channel: int, in_features: int,
                 latent_size: int, device=None, dtype=None):
        super().__init__()
        self.object_size = object_size
        self.num_channel = num_channel
        os_ = object_size
        self.Dense_0 = Dense(in_features, latent_size * 2, device, dtype=dtype)
        self.Dense_1 = Dense(latent_size * 2, os_ // 4 * (os_ // 4) * 32, device, dtype=dtype)
        self.Conv_0 = Conv(32, 64, (3, 3), device=device, dtype=dtype)
        self.Conv_1 = Resize2xConv(64, 32, (os_ // 2, os_ // 2), device, dtype=dtype)
        self.Conv_2 = Resize2xConv(32, num_channel + 1, (os_, os_), device, dtype=dtype)

    def forward(self, z_what: torch.Tensor):
        os_ = self.object_size
        x = F.relu(self.Dense_0(z_what))
        x = F.relu(self.Dense_1(x))
        x = x.reshape(-1, os_ // 4, os_ // 4, 32)
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = self.Conv_2(x)
        return torch.sigmoid(x[..., :self.num_channel]), torch.sigmoid(x[..., self.num_channel:])


class SpairEncoder(nn.Module):
    """SPAIR backbone and latent program (spair/spair.py:368-496).

    Backbone: 3 convs (128, k=4, strides 2/2/3) to a gh x gw cell grid, 1x1
    convs to 100 features per cell, then box net -> z_where (+8 passthrough),
    STN glimpse crop, object encoder -> z_what, depth net, presence net with
    Binary-Concrete sampling. With ``glimpse_local`` the object encoder is
    ``ObjEncoderScramble`` and four more outputs follow: the per-cell local
    latent, its mean and sigma, and the scrambled glimpses.
    """

    n_z_where = 4
    n_pass_through = 8

    def __init__(self, image_hw: Tuple[int, int], num_channel: int, object_size: int,
                 latent_size: int, tau: float, concat: bool = False,
                 glimpse_local: bool = False, patch_size: int = 4,
                 local_latent_size: int = 64, device=None, dtype=None):
        super().__init__()
        self.object_size = object_size
        self.tau = tau
        self.concat = concat
        self.glimpse_local = glimpse_local
        self.conv1 = Conv(num_channel, 128, (4, 4), stride=2, device=device, dtype=dtype)
        self.conv2 = Conv(128, 128, (4, 4), stride=2, device=device, dtype=dtype)
        self.conv3 = Conv(128, 128, (4, 4), stride=3, device=device, dtype=dtype)
        self.z1 = Conv(128, 128, (1, 1), padding="VALID", device=device, dtype=dtype)
        self.z2 = Conv(128, 128, (1, 1), padding="VALID", device=device, dtype=dtype)
        self.z3 = Conv(128, 100, (1, 1), padding="VALID", device=device, dtype=dtype)
        feat = 100 + (16 if concat else 0)
        nw, npt = self.n_z_where, self.n_pass_through
        self.where_d1 = Dense(feat, 128, device, dtype=dtype)
        self.where_d2 = Dense(128, 64, device, dtype=dtype)
        self.where_d3 = Dense(64, nw * 2 + npt, device, dtype=dtype)
        self.depth_d1 = Dense(feat + npt + nw + latent_size, 64, device, dtype=dtype)
        self.depth_d2 = Dense(64, 2 + npt, device, dtype=dtype)
        self.pres_d1 = Dense(feat + npt + nw + latent_size + 1, 64, device, dtype=dtype)
        self.pres_d2 = Dense(64, 1, device, dtype=dtype)
        if glimpse_local:
            self.obj_encoder = ObjEncoderScramble(object_size, num_channel, latent_size,
                                                  patch_size, local_latent_size, device,
                                                  dtype=dtype)
        else:
            self.obj_encoder = ObjEncoder(object_size, num_channel, latent_size, device,
                                          dtype=dtype)
        if concat:
            self.zl_d1 = Dense(local_latent_size, 16, device, dtype=dtype)
            self.zl_d2 = Dense(16, 16, device, dtype=dtype)

    def forward(self, x: torch.Tensor, noise: Noise, z_l: Optional[torch.Tensor] = None):
        b = x.shape[0]
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        h = F.relu(self.conv3(h))
        h = F.relu(self.z1(h))
        h = F.relu(self.z2(h))
        z = F.relu(self.z3(h))  # [B, gh, gw, 100]
        gh, gw = z.shape[1], z.shape[2]
        k = gh * gw

        features = z.reshape(b * k, z.shape[-1])
        if self.concat:
            if z_l is None:
                raise ValueError("concat_backbone requires z_l")
            zl = F.relu(self.zl_d2(F.relu(self.zl_d1(z_l))))
            zl = zl[:, None, :].expand(b, k, zl.shape[-1]).reshape(b * k, -1)
            features = torch.cat([features, zl], dim=-1)

        nw = self.n_z_where
        wh = self.where_d3(F.relu(self.where_d2(F.relu(self.where_d1(features)))))
        z_where_mean = wh[:, :nw]
        z_where_sigma = F.softplus(wh[:, nw:2 * nw] - 1.0)
        features_1 = F.relu(wh[:, 2 * nw:])
        z_where = reparameterize(z_where_mean, z_where_sigma,
                                 noise.normal_like(z_where_sigma, per_example=True))

        partial_program = z_where
        z_where_grid = z_where.reshape(b, gh, gw, nw)

        all_glimpses, _ = stn_crop(x, z_where_grid, (self.object_size, self.object_size))
        if self.glimpse_local:
            (z_what, z_what_mean, z_what_sigma, zl_g, zl_g_mean, zl_g_sig,
             x_hat_glimpses) = self.obj_encoder(all_glimpses, noise)
        else:
            z_what, z_what_mean, z_what_sigma = self.obj_encoder(all_glimpses, noise)

        partial_program = torch.cat([partial_program, z_what], dim=1)
        layer_inp = torch.cat([features, features_1, partial_program], dim=1)

        dh = self.depth_d2(F.relu(self.depth_d1(layer_inp)))
        z_depth_mean = dh[:, :1]
        z_depth_sigma = F.softplus(dh[:, 1:2])
        features_2 = F.relu(dh[:, 2:])
        z_depth = reparameterize(z_depth_mean, z_depth_sigma,
                                 noise.normal_like(z_depth_sigma, per_example=True))
        partial_program = torch.cat([partial_program, z_depth], dim=1)

        layer_inp = torch.cat([features, features_2, partial_program], dim=1)

        z_pres_logits = torch.clamp(self.pres_d2(F.relu(self.pres_d1(layer_inp))), -10.0, 10.0)
        z_pres_pre_sigmoid = concrete_binary_pre_sigmoid_sample(
            z_pres_logits, self.tau, noise.uniform_like(z_pres_logits, per_example=True))
        z_pres = torch.sigmoid(z_pres_pre_sigmoid)

        def grid(v):
            return v.reshape(b, gh, gw, -1)

        base = (grid(z_what), grid(z_what_mean), grid(z_what_sigma),
                z_where_grid, grid(z_where_mean), grid(z_where_sigma),
                grid(z_depth), grid(z_depth_mean), grid(z_depth_sigma),
                grid(z_pres), grid(z_pres_logits), grid(z_pres_pre_sigmoid),
                all_glimpses)
        if self.glimpse_local:
            return base + (grid(zl_g), grid(zl_g_mean), grid(zl_g_sig), x_hat_glimpses)
        return base


class SpairDecoder(nn.Module):
    """Decode every cell's object and paste it onto a full canvas (spair/spair.py:500-532).

    With ``fused`` the paste is left to the fused render: the third output is
    then (ys, xs), the paste's sample coordinates, not the canvases.
    """

    def __init__(self, image_hw: Tuple[int, int], object_size: int, num_channel: int,
                 in_features: int, latent_size: int, device=None, dtype=None):
        super().__init__()
        self.image_hw = tuple(image_hw)
        self.object_size = object_size
        self.num_channel = num_channel
        self.ObjDecoder_0 = ObjDecoder(object_size, num_channel, in_features, latent_size,
                                       device, dtype=dtype)

    def forward(self, z_what: torch.Tensor, z_where: torch.Tensor, fused: bool = False):
        b, gh, gw, d = z_what.shape
        k = gh * gw
        rgb, alpha = self.ObjDecoder_0(z_what.reshape(b * k, d))
        os_ = self.object_size
        obj_recon_unnorm = rgb.reshape(b, k, os_, os_, self.num_channel)
        obj_recon_alpha = alpha.reshape(b, k, os_, os_, 1)
        if fused:
            ys, xs, obj_bbox_mask = paste_sample_coords(z_where, self.image_hw, (os_, os_))
            return obj_recon_unnorm, obj_recon_alpha, (ys, xs), obj_bbox_mask
        concat = torch.cat([obj_recon_unnorm, obj_recon_alpha], dim=-1)
        obj_full_recon_unnorm, obj_bbox_mask = stn_paste(concat, z_where, self.image_hw)
        return obj_recon_unnorm, obj_recon_alpha, obj_full_recon_unnorm, obj_bbox_mask


def fused_decode_render(decoder: SpairDecoder, noise: Noise, z_what, z_where, z_depth, z_pres,
                        bg_recon, num_channel: int, image_hw: Tuple[int, int],
                        noise_scale: float = 0.01, windowed: bool = False):
    """Training decode + paste + composite through the fused render.

    The math of decoder(...) -> render(training=True), with the per-cell
    canvases kept out of device memory by the kernel pair on a GPU:
    the full-canvas pair, or with ``windowed`` the row-windowed pair (the same
    function, each cell confined to its row band). The kernels take float32:
    bfloat16 activations go up at their boundary, as the JAX package casts
    them for its Pallas kernels (split_vae_tpu/nn/spair_nets.py:424-431).
    The kernels key image i's noise by seed + i; under data parallelism the
    seed is offset by rank*B (``Noise.image_seed``), so the ranks' fields are
    the 1-rank field of the global batch, as the JAX package's shard-mapped
    render seeds shard j (split_vae_tpu/nn/spair_nets.py:448-487).
    Returns (obj_recon_unnorm, obj_recon_alpha, obj_bbox_mask, x_recon).
    """
    obj_ru, obj_ra, (ys, xs), bbox = decoder(z_what, z_where, fused=True)
    concat = torch.cat([obj_ru, obj_ra], dim=-1).float()
    b = concat.shape[0]
    zp = z_pres.reshape(b, -1).float()
    wd = (torch.sigmoid(-z_depth.float()) + 0.5).reshape(b, -1)
    bg_img = torch.broadcast_to(as_like(bg_recon, concat),
                                (b, image_hw[0], image_hw[1], num_channel))
    render = (windowed_kernels.fused_paste_render_windowed if windowed
              else render_kernels.fused_paste_render)
    x_recon = render(concat, ys, xs, zp, wd, bg_img, noise.image_seed(b), noise_scale)
    return obj_ru, obj_ra, bbox, x_recon


def render(obj_full_recon_unnorm: torch.Tensor, background_img, z_depth: torch.Tensor,
           z_pres: torch.Tensor, z_pres_logits: Optional[torch.Tensor], training: bool,
           num_channel: int, eps: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Depth-aware differentiable alpha compositing (spair/spair.py:534-579).

    Train: the Concrete z_pres sample, and N(0, 0.01) noise on the object RGB
    before clipping (``eps`` [B,K,H,W,C] are the standard normals, drawn from
    ``generator`` if None). Test: round(sigmoid(z_pres_logits)) floored at 1e-8.
    The composite runs in float32 whatever the activations' dtype
    (split_vae_tpu/nn/spair_nets.py:508-514).
    """
    obj_full_recon_unnorm = obj_full_recon_unnorm.float()
    z_depth, z_pres = z_depth.float(), z_pres.float()
    if z_pres_logits is not None:
        z_pres_logits = z_pres_logits.float()
    b = z_depth.shape[0]
    k = z_depth.shape[1] * z_depth.shape[2]
    depth_w = (torch.sigmoid(-z_depth.reshape(b, k)) + 0.5)
    if training:
        zp = z_pres.reshape(b, k)
        rgb_shape = obj_full_recon_unnorm.shape[:-1] + (num_channel,)
        if eps is None:
            eps = torch.randn(rgb_shape, generator=generator,
                              device=obj_full_recon_unnorm.device)
        noise = 0.01 * eps
    else:
        zp = torch.clamp_min(torch.round(torch.sigmoid(z_pres_logits.reshape(b, k))), 1e-8)
        noise = None
    bg = as_like(background_img, obj_full_recon_unnorm)
    return render_kernels.composite(obj_full_recon_unnorm, zp, depth_w, bg, noise)
