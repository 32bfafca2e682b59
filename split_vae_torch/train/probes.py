"""Evaluation probes (split_vae_tpu/train/probes.py): the frozen SVHN
classifier's disentanglement accuracies, and the classifier's training.

Reference: vae/trainer.py:213-264 (the frozen classifier on reconstructions
with resampled latents) and vae/classifier.py (its pretraining).

Reference quirk kept: the recon probe feeds the *un-rescaled* decoder mean to
the classifier, the resampled-latent probes the rescaled [0, 1] decode
(vae/trainer.py:214,219,224). The JAX package's redesign is kept too: each
resampled probe has a ``probe_*_rangefix`` companion on the raw decoder mean
(the classifier's own input range), and the GM variant adds the
cross-cluster probes ``probe_swapped_y_{z_g,transfer}_acc_rangefix``, which
decode with the batch neighbour's y-prior draw (``roll(., 1, 0)``).

Weights: ``classifier_weights_path`` keys them by dataset flavour with the
JAX package's names. ``load_or_train_classifier`` reads the ``.msgpack`` that
the JAX package wrote there (the repository commits two under ``models/``), or
else the port's own ``.pt`` of the same stem, or else trains one and writes
that ``.pt``.
"""

from __future__ import annotations

import os
import types
from typing import Callable, Dict, Optional

import numpy as np
import torch

from split_vae_torch.core import checkpoint as ckpt
from split_vae_torch.core.metrics import AccuracyMetric, MeanMetrics
from split_vae_torch.core.noise import Noise
from split_vae_torch.core.state import create_train_state
from split_vae_torch.data.loader import ArrayDataset, iterate_batches, to_device
from split_vae_torch.data.svhn import get_svhn
from split_vae_torch.nn.classifier import Classifier
from split_vae_torch.nn.common import activation_dtype, init_params
from split_vae_torch.train.optim import classifier_optimizer
from split_vae_torch.train.steps import normalize_images


def make_vae_probe_step(model, classifier: Classifier, gm: bool) -> Callable:
    """Returns probe(out, labels, noise) -> {metric: 0-d tensor}, under
    ``torch.no_grad``, for LGVae (gm=False) or LGGMVae (gm=True).

    ``out`` is the eval step's forward tuple, ``labels`` one-hot. Draws from
    ``noise``, in this order: the random z_l [B, local], the random z_g (N(0,
    1) [B, global] for LGVae; for LGGMVae normals [B, global] around the y
    prior, vae/trainer.py:261), and for LGGMVae the swapped-y normals [B,
    global]."""

    def probe(out, labels: torch.Tensor, noise: Noise) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            y_true = torch.argmax(labels, dim=-1)

            def acc(x, target=y_true):
                pred = torch.argmax(classifier(x, False), dim=-1)
                return torch.mean((pred == target).to(torch.float32))

            random_z_l = noise.normal(out.z_x_hat.shape, per_example=True)
            if gm:
                random_z_g = (out.z_prior_mean
                              + noise.normal(out.z_prior_mean.shape, per_example=True)
                              * out.z_prior_sig)
            else:
                random_z_g = noise.normal(out.z_x.shape, per_example=True)
            metrics = {
                "classifier_recon_acc": acc(out.x_mean),
                "classifier_random_z_l_acc": acc(model.decode(out.z_x, random_z_l)[0]),
                "classifier_random_z_g_acc": acc(model.decode(random_z_g, out.z_x_hat)[0]),
                "probe_random_z_l_acc_rangefix": acc(
                    model.decode(out.z_x, random_z_l, rescale=False)[0]),
                "probe_random_z_g_acc_rangefix": acc(
                    model.decode(random_z_g, out.z_x_hat, rescale=False)[0]),
            }
            if gm:
                swap_mean = torch.roll(out.z_prior_mean, 1, dims=0)
                swap_sig = torch.roll(out.z_prior_sig, 1, dims=0)
                z_g_swap = swap_mean + noise.normal(swap_mean.shape, per_example=True) * swap_sig
                x_swap = model.decode(z_g_swap, out.z_x_hat, rescale=False)[0]
                metrics["probe_swapped_y_z_g_acc_rangefix"] = acc(x_swap)
                metrics["probe_swapped_y_transfer_acc_rangefix"] = acc(
                    x_swap, torch.roll(y_true, 1, dims=0))
        return metrics

    return probe


def classifier_weights_path(config) -> str:
    """The JAX package's weights path, keyed by dataset flavour for synthetic
    runs (a classifier of one flavour scores chance on another); real-data
    runs keep the reference-shaped name."""
    if getattr(config, "synthetic_data", False):
        style = getattr(config, "synthetic_style", "blobs") or "blobs"
        size = getattr(config, "synthetic_size", 0) or 512
        name = f"svhn_classifier_weights_synth_{style}_{size}.msgpack"
    else:
        name = "svhn_classifier_weights.msgpack"
    return os.path.join("models", name)


def _dtype(config):
    """The classifier computes in the run's dtype, as the JAX package's
    process-wide activation dtype makes it."""
    return activation_dtype(getattr(config, "compute_dtype", "float32"))


def _port_weights_path(config) -> str:
    return os.path.splitext(classifier_weights_path(config))[0] + ".pt"


def train_classifier(config, epochs: Optional[int] = None, verbose: bool = True,
                     device="cuda") -> Classifier:
    """Trains the SVHN probe classifier (vae/classifier.py:14-109) on
    ``device`` and writes it to the ``.pt`` beside ``classifier_weights_path``.

    As in the JAX package: batch 32, AMSGrad at 1e-4, 2 epochs on synthetic
    data or 20 otherwise, each epoch's order from ``iterate_batches(seed=
    epoch)``, and the reference's quirk of training on train ∪ test
    (vae/classifier.py:35), from the run's own dataset flavour. Weights come
    from a generator seeded with config.seed, the dropout masks from one
    seeded with config.seed + 17."""
    epochs = epochs if epochs is not None else (2 if config.synthetic_data else 20)
    batch_size = 32
    cfg = types.SimpleNamespace(
        label=True, synthetic_data=config.synthetic_data, data_dir=config.data_dir,
        seed=config.seed, synthetic_style=getattr(config, "synthetic_style", "blobs"),
        synthetic_size=getattr(config, "synthetic_size", 0))
    train_ds, test_ds, _ = get_svhn(cfg, extra=False)
    train_ds = ArrayDataset(np.concatenate([train_ds.images, test_ds.images]),
                            np.concatenate([train_ds.labels, test_ds.labels]))

    model = Classifier(device=device, dtype=_dtype(config))
    init_params(model, torch.Generator(device=device).manual_seed(config.seed))
    state = create_train_state(model, classifier_optimizer(), seed=config.seed + 17)

    for epoch in range(epochs):
        mm = MeanMetrics()
        for images, labels in iterate_batches(train_ds, batch_size, seed=epoch):
            x = normalize_images(to_device(images, device), "tanh")
            labels = to_device(labels, device)
            logits = model(x, True, Noise(state.generator))
            loss = -torch.mean(torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1))
            state.apply_gradients(torch.autograd.grad(loss, state.params))
            acc = torch.mean((torch.argmax(logits, -1) == torch.argmax(labels, -1))
                             .to(torch.float32))
            mm.update({"loss": loss.detach(), "acc": acc})
        test_acc = evaluate_classifier(model, test_ds, batch_size, drop_remainder=True)
        if verbose:
            r = mm.result()
            print(f"classifier epoch {epoch + 1}: train loss {r['loss']:.4f} "
                  f"acc {r['acc']:.4f} test acc {test_acc:.4f}")

    ckpt.save_weights(_port_weights_path(config), model)
    return model


def load_or_train_classifier(config, device="cuda", verbose: bool = True) -> Classifier:
    """The JAX package's ``.msgpack``, else the port's ``.pt``, else a newly
    trained classifier (vae/trainer.py:81-89)."""
    for path in (classifier_weights_path(config), _port_weights_path(config)):
        if os.path.exists(path):
            return ckpt.load_weights(path, Classifier(device=device, dtype=_dtype(config)))
    if verbose:
        print("Classifier model not found, training a new classifier")
    return train_classifier(config, verbose=verbose, device=device)


def evaluate_classifier(model: Classifier, test_ds: ArrayDataset, batch_size: int = 256,
                        drop_remainder: bool = False) -> float:
    """The frozen classifier's accuracy on test images (vae/trainer.py:90-96)."""
    device = next(model.parameters()).device
    acc = AccuracyMetric()
    with torch.no_grad():
        for images, labels in iterate_batches(test_ds, batch_size, shuffle=False,
                                              drop_remainder=drop_remainder):
            acc.update(labels, model(normalize_images(to_device(images, device), "tanh"), False))
    return acc.result()
