"""The train and eval steps (split_vae_tpu/train/steps.py), SPAIR and VAE families.

A SPAIR train step: raw batch -> [0, 1] floats -> for lg_spair the patch
scramble on the device -> forward (the crop and the fused render through their
kernels on a GPU) -> loss -> backward -> clip, Adam, skip of non-finite
updates. A VAE-family train step (LGVae, LGGMVae, GMVae): uint8 batch ->
[-1, 1] floats -> the augmentation on the device -> forward -> the model's
loss -> backward -> Adam, skip of non-finite updates. GMVae too gets the
augmented 6-channel input and reads its first 3 channels, so the
augmentation's draws are spent as in the JAX step. On one process both
families' train steps run on the card as one CUDA graph (``train/graphs.py``).

``config.compute_dtype``: 'float32', or 'bfloat16', where every Dense and
Conv of the model computes in bfloat16 (``nn/common.py``) while the
parameters, their gradients and the optimizer's state stay float32; a step
refuses a model built in the other dtype. The steps turn TF32 off for
matmuls and cuDNN convolutions in both modes, which would otherwise break
parity with the float32 reference. Where the JAX step pins single-pass
bfloat16 for the float32 dots left inside it (``matmul_precision``,
split_vae_tpu/train/steps.py:70-79), the port sets nothing: no float32
matmul or convolution is left in its bfloat16 train steps (the crop and the
render are its own kernels, the geometry and the losses elementwise).

Data and tensor parallelism (``mesh``, ``parallel/mesh.py``): the train
steps take their data index's rows of the global batch, draw the global
batch's noise and keep those rows (``core/noise.py``), and reduce the
gradients with one flat all-reduce over the data group before the optimizer
sees them (XLA's psum over 'data'), so the clip, Adam and the non-finite skip
take the same decision on every rank of a data group. Every loss is a mean
over the batch, so the data group's mean gradient is the global batch's. The
ranks of a model group take the same rows and draws; their sharded layers
gather their blocks in the forward (``parallel/tensor.py``), so the
gradients of the replicated leaves are equal across the group up to the
card's unreproducible sums, and their mean over the whole world makes them
equal (``parallel/mesh.py::reduce_gradients_``). The eval steps run on one
rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from split_vae_torch.core import tracing
from split_vae_torch.core.noise import Noise
from split_vae_torch.core.state import TrainState
from split_vae_torch.nn.common import activation_dtype
from split_vae_torch.parallel.mesh import Mesh, reduce_gradients_
from split_vae_torch.ops.patches import augment_batch, augment_draws
from split_vae_torch.train import losses
from split_vae_torch.train.graphs import GraphedStep
from split_vae_torch.train.optim import notfinite_count


def normalize_images(batch: torch.Tensor, mode: str) -> torch.Tensor:
    """uint8 -> float in the model's range: 'tanh' [-1, 1], 'unit' [0, 1]; floats pass."""
    if batch.dtype == torch.uint8:
        x = batch.to(torch.float32) / 255.0
        return x * 2.0 - 1.0 if mode == "tanh" else x
    return batch.to(torch.float32)


def use_fp32() -> None:
    """Full-fp32 matmuls and convolutions (cuDNN would default to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def model_inputs(config, x: torch.Tensor, noise: Noise) -> torch.Tensor:
    """The model's input: lg_spair reads the image beside its scrambled view."""
    if config.model != "lg_spair":
        return x
    return augment(config, x, noise)


def augment(config, x: torch.Tensor, noise: Noise) -> torch.Tensor:
    """config.augmentation of x, its draws taken from ``noise``."""
    kind, size = config.augmentation, config.patch_size
    return augment_batch(x, kind, size, u=augment_draws(kind, x.shape, size, noise))


def check_compute_dtype(config, model) -> None:
    """Raises when ``model`` was built in another compute dtype than
    config.compute_dtype asks for (the intent of the JAX package's
    ``_check_activation_dtype``, split_vae_tpu/train/steps.py:52-67)."""
    want = activation_dtype(config.compute_dtype)
    have = getattr(model, "compute_dtype", None)
    if have != want:
        raise ValueError(f"compute dtype mismatch: config.compute_dtype is "
                         f"{config.compute_dtype!r} but the model was built with "
                         f"{have or 'float32'}; build it from the same config")


def _apply(state: TrainState, total: torch.Tensor, metrics, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Backward of ``total``, the data group's mean of the gradients, the
    optimizer update in place; the step's metrics (this rank's)."""
    params = state.params
    with tracing.span("step.backward"):
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    with tracing.span("step.reduce"):
        reduce_gradients_(grads, state.model, mesh)
    with tracing.span("step.optimizer"):
        state.apply_gradients(grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        cnt = notfinite_count(state.opt_state)
        if cnt is not None:
            metrics["notfinite_updates"] = cnt.to(torch.float32)
    return metrics


def vae_loss_fn(config) -> Callable:
    """(out, images) -> (total, metrics) of config.model (train/steps.py:83-96)."""
    if config.model == "lgvae":
        return lambda out, images: losses.lgvae_loss(out, images, config.beta)
    if config.model == "lggmvae":
        return lambda out, images: losses.lggmvae_loss(out, images, config.beta, config.alpha,
                                                       config.y_size)
    if config.model == "gmvae":
        return lambda out, images: losses.gmvae_loss(out, images, config.beta, config.alpha,
                                                     config.y_size)
    raise NotImplementedError(config.model)


def make_vae_train_step(config, mesh: Mesh = Mesh()) -> Callable:
    """Returns train_step(state, batch, replay=None) -> (state, metrics) for
    LGVae, LGGMVae or GMVae (config.model); ``batch`` is this rank's rows.

    Draw order as in the JAX step: the augmentation's draws (k_aug), then the
    model's (k_sample, then the GM models' dropout keep masks; see their
    docstrings). ``replay`` (tests only) lists them in that order; otherwise
    they come from ``state.generator``.

    ``train/graphs.py`` decides where the step runs as one CUDA graph; its
    ``eager`` runs the step without one.
    """
    loss_of = vae_loss_fn(config)
    use_fp32()

    def body(state: TrainState, batch: torch.Tensor, noise: Noise) -> Dict[str, torch.Tensor]:
        check_compute_dtype(config, state.model)
        with tracing.span("step.inputs"):
            images = augment(config, normalize_images(batch, "tanh"), noise)
        with tracing.span("step.forward"):
            out = state.model(images, True, noise)
        with tracing.span("step.loss"):
            total, metrics = loss_of(out, images)
        del out  # the outputs the backward does not keep go before it
        return _apply(state, total, metrics, mesh)

    return GraphedStep(body, mesh)


def make_vae_eval_step(config, model) -> Callable:
    """Returns eval_step(generator, batch, replay=None) -> (out, metrics, images),
    under ``torch.no_grad``: training=False (no dropout), the sampling noise
    stays on, as in the reference's test steps (vae/trainer.py:199-292)."""
    loss_of = vae_loss_fn(config)
    check_compute_dtype(config, model)
    use_fp32()

    def eval_step(generator: torch.Generator, batch: torch.Tensor,
                  replay: Optional[Sequence[torch.Tensor]] = None):
        with torch.no_grad():
            noise = Noise(generator, replay)
            images = augment(config, normalize_images(batch, "tanh"), noise)
            out = model(images, False, noise)
            _, metrics = loss_of(out, images)
        return out, metrics, images

    return eval_step


def make_spair_train_step(config, windowed_render: bool = False,
                          mesh: Mesh = Mesh()) -> Callable:
    """Returns train_step(state, batch, replay=None) -> (state, metrics);
    ``batch`` is this rank's rows.

    ``windowed_render`` sends the fused render through the row-windowed kernel
    pair (``kernels/render_windowed.py``) instead of the full-canvas one.

    ``replay`` (tests only) lists the noise to use in draw order: the
    scramble's uniforms, then the model's draws; otherwise everything is drawn
    from ``state.generator``. The render's seed is drawn from it either way.
    Metrics are 0-d tensors on the device.

    The anneals read the step's count on the device (``Noise.step``), so the
    step copies nothing from the host. ``train/graphs.py`` decides where the
    step runs as one CUDA graph; its ``eager`` runs the step without one.
    """
    use_fp32()

    def body(state: TrainState, batch: torch.Tensor, noise: Noise) -> Dict[str, torch.Tensor]:
        check_compute_dtype(config, state.model)
        with tracing.span("step.inputs"):
            images = model_inputs(config, normalize_images(batch, "unit"), noise)
        with tracing.span("step.forward"):
            out = state.model(images, True, noise, windowed=windowed_render)
        with tracing.span("step.loss"):
            total, metrics = losses.spair_loss(out, images, config, noise.step(), training=True)
        del out  # the outputs the backward does not keep go before it
        return _apply(state, total, metrics, mesh)

    return GraphedStep(body, mesh)


def make_spair_eval_step(config, model) -> Callable:
    """Returns eval_step(generator, batch, labels=None, replay=None) ->
    (out, metrics, images), under ``torch.no_grad``.

    Reference quirks preserved: the test step calls the model with
    training=True (spair/trainer.py:241), so the Concrete sampling and the
    render noise stay on, and with fused=False, so the per-cell canvases that
    the eval's consumers read exist; the loss runs with training=False at
    step 0. ``replay`` (tests only) lists the noise in draw order.
    """
    check_compute_dtype(config, model)
    use_fp32()

    def eval_step(generator: torch.Generator, batch: torch.Tensor,
                  labels: Optional[torch.Tensor] = None,
                  replay: Optional[Sequence[torch.Tensor]] = None):
        with torch.no_grad():
            noise = Noise(generator, replay)
            images = model_inputs(config, normalize_images(batch, "unit"), noise)
            out = model(images, True, noise, fused=False)
            _, metrics = losses.spair_loss(out, images, config, 0, training=False)
            if labels is not None:
                pred_count = torch.sum(torch.round(torch.sigmoid(out.z_pres_logits)),
                                       dim=(1, 2, 3))
                metrics.update(count_metrics(pred_count, labels))
        return out, metrics, images

    return eval_step


def count_metrics(pred_count: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Object-count eval columns (spair/trainer.py:292-301).

    ``MAPE test`` keeps the exact tf.keras mean_absolute_percentage_error
    semantics: the denominator is clipped at 1e-7, so an image with zero
    objects contributes err * 1e9. ``MAPE_nonzero test`` is the same statistic
    over the images whose count is above zero.
    """
    labels = labels.to(torch.float32)
    err = torch.abs(labels - pred_count)
    pct = err / torch.clamp_min(torch.abs(labels), 1e-7) * 100.0
    nonzero = (torch.abs(labels) > 0).to(torch.float32)
    return {
        "MAE test": torch.mean(err),
        "MAPE test": torch.mean(pct),
        "MAPE_nonzero test": torch.sum(pct * nonzero) / torch.clamp_min(torch.sum(nonzero), 1.0),
        "count_acc": torch.mean((pred_count == labels).to(torch.float32)),
    }
