"""SPAIR-family PNG artifacts (split_vae_tpu/viz/spair_artifacts.py).

The reference's visualizer surface, and its filename typos, which are part of
its output contract: ``reconstruction_test`` -> ``x_reconstrcution_test<s>.png``
[sic, spair/visualizer.py:79], ``reconstruction_bbox`` ->
``x_reconstrcution_bbox<s>.png``, ``glimpses_reconstruction_test`` ->
``glimpses<s>.png``, ``glimpses_local_reconstruction_test`` ->
``glimpses_local<s>.png``, ``x_hat_reconstruction_test`` ->
``x_hat_reconstrcution_test<s>.png``, ``train_decomposition_plot`` ->
``train_recon_it_<s>.png``.

Each writer but the last runs its own forward on the first ``n`` images, as
the JAX package's ``_forward`` does: training=True (the Concrete sample and
the render noise on) and fused=False (the per-cell canvases exist; the crop
runs its kernel on a GPU, the render is the plain composite), its draws from
the ``Noise`` it is handed. The canvases are the JAX package's, built the
same way in numpy, and each writer returns its canvas (``train_decomposition_plot``
too, where the JAX one returns None). A figure of several panels is one PNG
with the panels side by side (``viz/png.py::write_panels``), without the
titles and the inferno/viridis colormaps: a one-channel panel is gray.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from split_vae_torch.core.noise import Noise
from split_vae_torch.viz.artifacts import on_model, to_host
from split_vae_torch.viz.canvases import draw_bounding_boxes, stack_rows
from split_vae_torch.viz.png import write_panels, write_png


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x)))


def _forward(model, images, noise: Noise):
    """The viz forward: training=True, fused=False (spair_artifacts.py:30-38)."""
    with torch.no_grad():
        return model(on_model(model, images), True, noise, fused=False)


def _clipped(*canvases):
    return [np.clip(c, 0, 1) for c in canvases]


def _decomposition(images, out, z_pres, n):
    """The 3-panel per-cell decomposition of the first ``n`` images: input,
    recon and each cell's canvas; the same weighted by alpha, presence and
    depth; the presence weights (spair/visualizer.py:14-81)."""
    num_cells = out.z_where.shape[1] * out.z_where.shape[2]
    h, w = images.shape[1:3]
    channel = min(3, images.shape[3])
    full = to_host(out.obj_full_recon_unnorm)
    obj_recon, obj_alpha = full[..., :channel], full[..., channel:]
    z_depth = to_host(out.z_depth).reshape(-1, num_cells, 1, 1, 1)
    x_recon = to_host(out.x_recon)

    canvas = np.empty((h * (num_cells + 2), w * n, channel))
    canvas_weighted = np.empty_like(canvas)
    canvas_weights = np.zeros_like(canvas)
    for i in range(n):
        cols = np.s_[i * w:(i + 1) * w]
        canvas[0:h, cols] = canvas_weighted[0:h, cols] = canvas_weights[0:h, cols] = (
            images[i, :, :, :3])
        canvas[h:2 * h, cols] = canvas_weighted[h:2 * h, cols] = (
            canvas_weights[h:2 * h, cols]) = x_recon[i]
        canvas[2 * h:, cols, :] = obj_recon[i].reshape(num_cells * h, w, channel)
        weighted = obj_recon[i] * obj_alpha[i] * z_pres[i] * _sigmoid(-z_depth[i])
        canvas_weighted[2 * h:, cols, :] = weighted.reshape(num_cells * h, w, channel)
        weights = (np.ones_like(obj_alpha[i]) * z_pres[i]).reshape(num_cells * h, w)
        canvas_weights[2 * h:, cols, 0] = weights
    return canvas, canvas_weighted, canvas_weights


def reconstruction_test(model, images, noise: Noise, filename: str = "", filepath: str = ".",
                        n: int = 10):
    """3-panel per-cell decomposition, presence from round(sigmoid(logits))
    (spair/visualizer.py:14-81)."""
    images = images[:n]
    out = _forward(model, images, noise)
    images = to_host(images)
    n = images.shape[0]
    num_cells = out.z_where.shape[1] * out.z_where.shape[2]
    z_pres = np.round(_sigmoid(to_host(out.z_pres_logits))).reshape(n, num_cells, 1, 1, 1)
    panels = _decomposition(images, out, z_pres, n)
    write_panels(os.path.join(filepath, f"x_reconstrcution_test{filename}.png"),
                 _clipped(*panels))
    return panels[0]


def reconstruction_bbox(model, images, noise: Noise, filename: str = "", filepath: str = ".",
                        n: int = 10):
    """Boxes gated by rounded presence on the inputs and the recons
    (spair/visualizer.py:84-137)."""
    images = images[:n]
    out = _forward(model, images, noise)
    images = to_host(images)
    n = images.shape[0]
    num_cells = out.z_where.shape[1] * out.z_where.shape[2]
    z_pres = np.round(_sigmoid(to_host(out.z_pres_logits))).reshape(n, num_cells, 1)
    boxes = to_host(out.obj_bbox_mask) * z_pres
    recon_w_bbox = draw_bounding_boxes(to_host(out.x_recon), boxes)
    img_w_bbox = draw_bounding_boxes(images[:, :, :, :3], boxes)
    canvas = stack_rows(images[:, :, :, :3], img_w_bbox, recon_w_bbox)
    write_png(os.path.join(filepath, f"x_reconstrcution_bbox{filename}.png"),
              np.clip(canvas, 0, 1))
    return canvas


def glimpses_reconstruction_test(model, images, noise: Noise, filename: str = "",
                                 filepath: str = ".", n: int = 10):
    """Glimpses, their recons and alphas, a column an image
    (spair/visualizer.py:140-202)."""
    images = images[:n]
    out = _forward(model, images, noise)
    n = images.shape[0]
    channel = min(3, images.shape[3])
    num_cells = out.z_where.shape[1] * out.z_where.shape[2]
    os_ = out.obj_recon_alpha.shape[2]
    glimpses = to_host(out.all_glimpses)[:n, :, :, :, :channel]
    recon = to_host(out.obj_recon_unnorm)[:n]
    alpha = to_host(out.obj_recon_alpha)[:n]

    cg = np.empty((os_ * num_cells, os_ * n, channel))
    cr = np.empty_like(cg)
    ca = np.zeros((os_ * num_cells, os_ * n))
    for i in range(n):
        cg[:, i * os_:(i + 1) * os_, :] = glimpses[i].reshape(num_cells * os_, os_, channel)
        cr[:, i * os_:(i + 1) * os_, :] = recon[i].reshape(num_cells * os_, os_, channel)
        ca[:, i * os_:(i + 1) * os_] = alpha[i].reshape(num_cells * os_, os_)
    write_panels(os.path.join(filepath, f"glimpses{filename}.png"), _clipped(cg, cr, ca))
    return cg


def glimpses_local_reconstruction_test(model, images, noise: Noise, filename: str = "",
                                       filepath: str = ".", n: int = 10):
    """Scrambled glimpses and their local-path recons (spair/visualizer.py:204-257);
    lg_glimpse_spair only (its x_hat, x_hat_recon are per glimpse)."""
    images = images[:n]
    out = _forward(model, images, noise)
    n = images.shape[0]
    channel = min(3, images.shape[3])
    num_cells = out.z_where.shape[1] * out.z_where.shape[2]
    os_ = out.obj_recon_alpha.shape[2]
    x_hat = to_host(out.x_hat)[:n]
    x_hat_recon = to_host(out.x_hat_recon)[:n]

    cg = np.empty((os_ * num_cells, os_ * n, channel))
    cr = np.empty_like(cg)
    for i in range(n):
        cg[:, i * os_:(i + 1) * os_, :] = x_hat[i].reshape(num_cells * os_, os_, channel)
        cr[:, i * os_:(i + 1) * os_, :] = x_hat_recon[i].reshape(num_cells * os_, os_, channel)
    write_panels(os.path.join(filepath, f"glimpses_local{filename}.png"), _clipped(cg, cr))
    return cg


def x_hat_reconstruction_test(model, images, noise: Noise, filename: str = "",
                              filepath: str = ".", n: int = 10):
    """LG-SPAIR's local-path recon strip (spair/visualizer.py:259-285)."""
    images = images[:n]
    out = _forward(model, images, noise)
    images = to_host(images)
    canvas = stack_rows(to_host(out.x_hat_recon)[:images.shape[0]], images[:, :, :, 3:6])
    write_png(os.path.join(filepath, f"x_hat_reconstrcution_test{filename}.png"),
              np.clip(canvas, 0, 1))
    return canvas


def train_decomposition_plot(images, out, filename: str = "", filepath: str = ".",
                             n: int = 10):
    """The decomposition of a train batch's eval forward, presence from the
    sample (spair/trainer.py:331-378)."""
    images = to_host(images)
    n = min(n, images.shape[0])
    num_cells = out.z_where.shape[1] * out.z_where.shape[2]
    z_pres = to_host(out.z_pres).reshape(images.shape[0], num_cells, 1, 1, 1)
    panels = _decomposition(images, out, z_pres, n)
    write_panels(os.path.join(filepath, f"train_recon_it_{filename}.png"), _clipped(*panels))
    return panels[0]
