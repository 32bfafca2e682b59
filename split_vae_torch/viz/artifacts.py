"""VAE-family PNG artifacts (split_vae_tpu/viz/artifacts.py).

The reference's visualizer surface and filenames (vae/visualizer.py):
``generate``, ``reconstruction_test_lg_vae``, ``style_transfer_test``,
``style_transfer_celeba``, ``generate_varying_latent``, ``generate_cluster``
and ``unseen_cluster_lg``, which the loop calls, and ``generate_traverse``,
``plot_latent_dims``, ``unseen_cluster``, ``unseen_cluster_lg_svhn`` and
``unseen_cluster_svhn``, which no CLI reaches (kept for API parity).

Each writer takes the model in place of the JAX package's (model, params) and
a ``Noise`` in place of its key: every draw comes from that ``Noise``, in the
order the JAX writer spends its keys (its sub-keys' draws, the model's draws
inside ``encode``/``get_y``). Forwards run under ``torch.no_grad`` on the
model's device; the canvases are numpy on the host, built as the JAX package
builds them, and each writer returns its canvas. Files are written by
``viz/png.py`` (no matplotlib): one pixel a canvas pixel.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

from split_vae_torch.core.noise import Noise
from split_vae_torch.models.vae import LGGMVae
from split_vae_torch.train.steps import normalize_images
from split_vae_torch.viz.canvases import grid_canvas, stack_rows, to_unit
from split_vae_torch.viz.png import write_png

# Hand-picked SVHN test indices used for style transfer (vae/visualizer.py:59).
SVHN_STYLE_IDX = np.array(
    [26, 101, 3025, 3129, 3182, 3233, 3547, 3695, 10462, 10471, 10601, 10608,
     16171, 16289, 16593, 16801, 101, 326, 333, 798, 841, 1189, 6186, 2651,
     1437, 1826, 5536])

# Extended hand-picked SVHN index set (vae/visualizer.py:389-391).
SVHN_CLUSTER_IDX = np.array(
    [26, 101, 3025, 3129, 3182, 3233, 3547, 3695, 10462, 10471, 10601, 10608,
     16171, 16289, 16593, 16801, 101, 326, 333, 798, 841, 1189, 6186, 2651,
     1437, 1826, 5536, 0, 3040, 3065, 3106, 3292, 3762, 10427, 10814, 16338,
     16505, 16606, 16655, 16875, 16880])

SCATTER_BINS = 256  # plot_latent_dims: the scatter's raster, SCATTER_BINS^2 pixels
HIST_BINS, HIST_HEIGHT, HIST_BAR = 10, 100, 10  # plt.hist's 10 bins, drawn as bars


def to_host(t) -> np.ndarray:
    """A tensor (any float dtype, any device) or array as a host numpy array;
    bfloat16 goes to float32, which numpy can hold."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def on_model(model, x) -> torch.Tensor:
    """Images (numpy or tensor) as a float32 tensor on the model's device."""
    return torch.as_tensor(x, dtype=torch.float32, device=_device(model))


def _rows(images: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Rows ``idx`` of a host image store in [-1, 1]: floats as they are,
    uint8 mapped as the steps map it (``normalize_images``); picking first is
    the same as mapping the whole store first."""
    rows = torch.from_numpy(np.ascontiguousarray(np.asarray(images)[idx]))
    return to_host(normalize_images(rows, "tanh"))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(idx, n).to(torch.float32)


def _prior_for_random_y(model, noise: Noise):
    """The y prior of one cluster drawn uniformly (one randint)."""
    return model.encode_y(_one_hot(noise.randint(model.y_size, (1,)), model.y_size))


@torch.no_grad()
def reconstruction_test_lg_vae(model, images, noise: Noise, filename: str = "",
                               filepath: str = ".", n: int = 10):
    """Paired recon/input strips (vae/visualizer.py:13-55). ``images`` is an
    augmented 6-channel batch in [-1, 1]."""
    x_test = to_host(images[:n])
    z_x, z_l = model.encode(on_model(model, x_test), noise)
    x_recon, x_hat_recon = model.decode(z_x, z_l, True)
    canvas_x = stack_rows(to_host(x_recon), to_unit(x_test[..., :3]))
    write_png(os.path.join(filepath, f"x_reconstruction_test{filename}.png"), canvas_x)
    canvas_x_hat = stack_rows(to_host(x_hat_recon), to_unit(x_test[..., 3:6]))
    write_png(os.path.join(filepath, f"x_hat_reconstruction_test{filename}.png"), canvas_x_hat)
    return canvas_x, canvas_x_hat


@torch.no_grad()
def style_transfer_test(model, test_images, noise: Noise, filename: str = "",
                        filepath: str = ".", n: int = 10):
    """SVHN content/style swap on hand-picked digits (vae/visualizer.py:57-85).

    ``test_images``: the SVHN test set, in [-1, 1] or as stored (uint8). The
    hand-picked indices assume the full 26k test set; they wrap for smaller
    (synthetic) sets. Draws: two permutations, then ``encode``'s."""
    pick = SVHN_STYLE_IDX % len(test_images)
    idx_x = to_host(noise.permutation(len(pick)))[:n]
    idx_h = to_host(noise.permutation(len(pick)))[:n]
    x = _rows(test_images, pick[idx_x])
    x_hat = _rows(test_images, pick[idx_h])
    z_x, z_l = model.encode(on_model(model, np.concatenate([x, x_hat], axis=-1)), noise)
    x_recon, _ = model.decode(z_x, z_l, True)
    canvas = stack_rows(to_unit(x), to_unit(x_hat), to_host(x_recon))
    write_png(os.path.join(filepath, f"style_transfer{filename}.png"), canvas)
    return canvas


@torch.no_grad()
def style_transfer_celeba(model, images, noise: Noise, filename: str = "",
                          filepath: str = ".", n: int = 10):
    """CelebA style transfer (vae/visualizer.py:88-125). ``images``: an
    augmented 6-channel batch in [-1, 1] of at least 2n samples."""
    x_test = to_host(images)
    x = x_test[:n, :, :, :3]
    x_hat = x_test[n:2 * n, :, :, :3]
    x_aug = np.concatenate([x_test[:n], np.concatenate([x, x_hat], axis=-1)], axis=0)
    z_x, z_l = model.encode(on_model(model, x_aug), noise)
    x_recon, _ = model.decode(z_x, z_l, True)
    x_recon = to_host(x_recon)
    canvas = stack_rows(
        to_unit(x_aug[:n, :, :, :3]), to_unit(x_aug[n:, :, :, 3:6]),
        x_recon[:n], x_recon[n:2 * n])
    write_png(os.path.join(filepath, f"style_transfer_celeba{filename}.png"), canvas)
    return canvas


@torch.no_grad()
def generate(model, noise: Noise, filename: str = "generated_image", filepath: str = "."):
    """10x10 prior samples; for LGGMVae around one random cluster's prior
    (vae/visualizer.py:155-181)."""
    g, l = model.global_latent_dims, model.local_latent_dims
    if isinstance(model, LGGMVae):
        pm, ps = _prior_for_random_y(model, noise)
        z_g = pm + ps * noise.normal((100, g))
    else:
        z_g = noise.normal((100, g))
    z_l = noise.normal((100, l))
    x_gen, _ = model.decode(z_g, z_l, True)
    canvas = grid_canvas(to_host(x_gen), 10, 10)
    write_png(os.path.join(filepath, f"{filename}.png"), canvas)
    return canvas


@torch.no_grad()
def generate_varying_latent(model, noise: Noise, vary: str, filename=None,
                            filepath: str = "."):
    """Vary-local ('lower') / vary-global ('upper') grids (vae/visualizer.py:201-270)."""
    g, l = model.global_latent_dims, model.local_latent_dims
    if isinstance(model, LGGMVae):
        pm, ps = _prior_for_random_y(model, noise)
    else:
        pm, ps = 0.0, 1.0
    if vary == "lower":
        z_l = noise.normal((100, l))
        z_g = (pm + ps * noise.normal((1, g))).expand(100, g)
    elif vary == "upper":
        z_l = noise.normal((1, l)).expand(100, l)
        z_g = pm + ps * noise.normal((100, g))
    else:
        raise ValueError(vary)
    x_gen, x_hat_gen = model.decode(z_g, z_l, True)
    name = filename or f"generate_varying_latent_{vary}"
    canvas = grid_canvas(to_host(x_gen), 10, 10)
    write_png(os.path.join(filepath, f"{name}.png"), canvas)
    if vary == "lower":
        canvas_hat = grid_canvas(to_host(x_hat_gen), 10, 10)
        write_png(os.path.join(filepath, f"x_hat_{name}.png"), canvas_hat)
        return canvas, canvas_hat
    return canvas


@torch.no_grad()
def generate_cluster(model, noise: Noise, vary: str, filename=None, filepath: str = "."):
    """Cluster-conditional generation for LGGMVae (vae/visualizer.py:272-314).
    Draws: one randint (the cluster), then per ``vary``: 'zg_zl' and 'zg' the
    z_g normals and the z_l normals; 'y_zg' a permutation of the clusters,
    the z_g normals [m, per, G], the z_l normals."""
    g, l, y_size = model.global_latent_dims, model.local_latent_dims, model.y_size
    pm, ps = _prior_for_random_y(model, noise)
    if vary == "zg_zl":
        z_g = (pm + ps * noise.normal((10, g))).repeat_interleave(10, dim=0)
        z_l = noise.normal((10, l)).repeat(10, 1)
    elif vary == "zg":
        z_g = pm + ps * noise.normal((100, g))
        z_l = noise.normal((1, l)).expand(100, l)
    elif vary == "y_zg":
        m = min(10, y_size)  # the reference assumes y_size >= 10
        pm, ps = model.encode_y(_one_hot(noise.permutation(y_size)[:m], y_size))  # [m, G]
        per = -(-100 // m)
        eps = noise.normal((m, per, g))
        z_g = (pm[:, None, :] + ps[:, None, :] * eps).reshape(m * per, -1)[:100]
        z_l = noise.normal((1, l)).expand(100, l)
    else:
        raise ValueError(vary)
    x_gen, _ = model.decode(z_g, z_l)
    name = filename or f"generate_cluster_{vary}"
    canvas = grid_canvas(to_host(x_gen), 10, 10)
    write_png(os.path.join(filepath, f"{name}.png"), canvas)
    return canvas


@torch.no_grad()
def generate_traverse(model, filepath: str = ".", span: float = 3.0, n: int = 30):
    """2-D latent traversal grid (vae/visualizer.py:183-198) of a single-path
    model (GMVae's ``decode``) with a 2-D latent."""
    if model.global_latent_dims != 2:
        raise NotImplementedError("Implemented for 2D latent only")
    zs = np.linspace(-span, span, n)
    z = torch.as_tensor([[z1, z2] for z1 in zs for z2 in zs], dtype=torch.float32,
                        device=_device(model))
    canvas = grid_canvas(to_host(model.decode(z)), n, n)
    write_png(os.path.join(filepath, "latent_space.png"), canvas)
    return canvas


def _histogram_bars(values: np.ndarray) -> np.ndarray:
    """``plt.hist``'s ten bins as a gray image: one HIST_BAR-wide white bar a
    bin, HIST_HEIGHT rows for the fullest."""
    counts, _ = np.histogram(values, bins=HIST_BINS)
    heights = np.rint(counts / max(counts.max(), 1) * HIST_HEIGHT).astype(int)
    canvas = np.zeros((HIST_HEIGHT, HIST_BINS * HIST_BAR))
    for j, hgt in enumerate(heights):
        canvas[HIST_HEIGHT - hgt:, j * HIST_BAR:(j + 1) * HIST_BAR] = 1.0
    return canvas


@torch.no_grad()
def plot_latent_dims(model, batches, noise: Noise, filepath: str = ".",
                     variational: bool = True):
    """Latent histograms and the first two dimensions' scatter
    (vae/visualizer.py:128-153), rasterized: the scatter as a
    SCATTER_BINS^2 ``np.histogram2d`` of (dim 1 up, dim 0 across), log(1 +
    count), the histograms with ``np.histogram``'s ten bins; gray images under
    the JAX package's names. Returns the latents."""
    zs = []
    for images in batches:
        z = model.encode(on_model(model, images), noise)
        if isinstance(z, tuple):
            z = z[0]
        zs.append(to_host(z))
    z = np.concatenate(zs)
    tag = "var" if variational else "det"
    counts, _, _ = np.histogram2d(z[:, 1], z[:, 0], bins=SCATTER_BINS)
    write_png(os.path.join(filepath, f"2d_latent_{tag}.png"), np.log1p(counts[::-1]))
    for i in range(min(z.shape[1], 16)):
        write_png(os.path.join(filepath, f"latent_{tag}_{i}.png"), _histogram_bars(z[:, i]))
    return z


@torch.no_grad()
def unseen_cluster(model, images, noise: Noise, filename: str = "", filepath: str = ".",
                   n: int = 10):
    """Per-input cluster-prior samples for GMVae (vae/visualizer.py:442-479).
    Draws: ``get_y``'s, then the z normals [n, 10, G]."""
    x_test = to_host(images[:n])
    h, w = x_test.shape[1:3]
    _, y_logits = model.get_y(on_model(model, x_test), noise)
    pm, ps = model.encode_y(_one_hot(torch.argmax(y_logits, dim=1), model.y_size))
    eps = noise.normal((n, 10, model.global_latent_dims))
    z_x = (pm[:, None, :] + ps[:, None, :] * eps).reshape(10 * n, -1)
    x_recon = to_host(model.decode(z_x))
    canvas = np.empty((h * 11, w * n, 3))
    for i in range(n):
        canvas[0:h, i * w:(i + 1) * w] = to_unit(x_test[i, :, :, :3])
        canvas[h:, i * w:(i + 1) * w] = x_recon[i * 10:(i + 1) * 10].reshape(h * 10, w, 3)
    write_png(os.path.join(filepath, f"unseen_cluster{filename}.png"), canvas)
    return canvas


@torch.no_grad()
def unseen_cluster_lg_svhn(model, test_images, noise: Noise, filename: str = "",
                           filepath: str = "."):
    """Hand-picked-digit cluster galleries for LGGMVae (vae/visualizer.py:385-413).
    ``test_images``: the SVHN test set, in [-1, 1] or as stored (uint8)."""
    x = _rows(test_images, SVHN_CLUSTER_IDX % len(test_images))
    x_test = np.concatenate([x, x], axis=-1)  # tiled to 6 channels (vae/visualizer.py:398)
    _, y_logits = model.get_y(on_model(model, x_test), noise)
    cluster = to_host(torch.argmax(y_logits, dim=1))
    canvas = None
    for c in range(model.y_size):
        members = x[cluster == c]
        if len(members):
            canvas = stack_rows(to_unit(members))
            write_png(os.path.join(filepath, f"unseen_cluster_{filename}_{c}.png"), canvas)
    return canvas


@torch.no_grad()
def unseen_cluster_svhn(model, test_images, noise: Noise, filename: str = "",
                        filepath: str = ".", n: int = 10):
    """GMVae on hand-picked digits (vae/visualizer.py:481-517). Draws: a
    permutation, then ``unseen_cluster``'s."""
    pick = SVHN_CLUSTER_IDX % len(test_images)
    sel = to_host(noise.permutation(len(pick)))[:n]
    x_test = _rows(test_images, pick[sel])
    return unseen_cluster(model, np.tile(x_test, (1, 1, 1, 2)), noise,
                          filename=filename, filepath=filepath, n=n)


@torch.no_grad()
def unseen_cluster_lg(model, batches, noise: Noise, filename: str = "", filepath: str = ".",
                      per_cluster: int = 7):
    """Per-cluster galleries sorted by confidence (vae/visualizer.py:318-383).
    ``batches``: augmented 6-channel image batches in [-1, 1]. Draws:
    ``get_y``'s, a batch after the other."""
    cluster_dict = defaultdict(list)
    for images in batches:
        images_np = to_host(images)
        _, y_logits = model.get_y(on_model(model, images), noise)
        probs = to_host(torch.softmax(y_logits, dim=1))
        cluster = probs.argmax(axis=1)
        for c in range(model.y_size):
            members = images_np[cluster == c][:, :, :, :3]
            scores = probs[cluster == c][:, c]
            for s, img in zip(scores, members):
                cluster_dict[c].append((float(s), img))
    canvas = None
    for c in range(model.y_size):
        if cluster_dict[c]:
            cluster_dict[c].sort(key=lambda p: p[0], reverse=True)
            samples = np.stack([p[1] for p in cluster_dict[c][:per_cluster]])
            canvas = stack_rows(to_unit(samples))
            write_png(os.path.join(filepath, f"unseen_cluster_{filename}_{c}.png"), canvas)
    return canvas
