"""The LG-SPAIR train step (split_vae_tpu/train/steps.py::make_spair_train_step).

One step: raw batch -> [0, 1] floats -> patch scramble on the device ->
forward (the fused render on a GPU) -> loss -> backward -> clip, Adam, skip
of non-finite updates. fp32 only: the step turns TF32 off for matmuls and
cuDNN convolutions, which would otherwise break parity with the f32 reference.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from split_vae_torch.core.noise import Noise
from split_vae_torch.core.state import TrainState
from split_vae_torch.ops.patches import augment_batch, scramble_shape
from split_vae_torch.train import losses
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


def make_spair_train_step(config) -> Callable:
    """Returns train_step(state, batch, replay=None) -> (state, metrics).

    ``replay`` (tests only) lists the noise to use in draw order: the
    scramble's uniforms, then the model's draws; otherwise everything is drawn
    from ``state.generator``. Metrics are 0-d tensors on the device.
    """
    if getattr(config, "compute_dtype", "float32") != "float32":
        raise NotImplementedError("only compute_dtype='float32' is ported yet")
    use_fp32()
    augmented = config.model == "lg_spair"

    def train_step(state: TrainState, batch: torch.Tensor,
                   replay: Optional[Sequence[torch.Tensor]] = None):
        noise = Noise(state.generator, replay)
        x = normalize_images(batch, "unit")
        if augmented:
            size = config.patch_size
            images = augment_batch(x, config.augmentation, size,
                                   u=noise.uniform(scramble_shape(x.shape, size)))
        else:
            images = x
        out = state.model(images, True, noise)
        total, metrics = losses.spair_loss(out, images, config, state.step, training=True)
        params = state.params
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        state.apply_gradients(grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        cnt = notfinite_count(state.opt_state)
        if cnt is not None:
            metrics["notfinite_updates"] = cnt.to(torch.float32)
        return state, metrics

    return train_step
