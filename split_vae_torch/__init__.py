"""SPLIT on PyTorch and CUDA: the port of ``split_vae_tpu`` to one NVIDIA H100.

The JAX package ``split_vae_tpu`` stays the reference; this package runs the
same models in PyTorch, with the TPU's Pallas kernels rewritten by hand as
CUDA kernels for Hopper (``sm_90a``). Nothing here imports JAX.

Layout (mirrors the JAX package where a counterpart exists):
  core/      configs, train state, the noise source of a stochastic forward
  ops/       distributions, STN, patch scramble, count prior
  nn/        layers and the SPAIR networks
  models/    LG-SPAIR and its factory
  train/     losses, schedules, optimizer, the train step
  interop/   flax parameter trees -> torch state_dicts
  kernels/   Python wrappers of the CUDA kernels, with their plain versions
  csrc/      CUDA sources, built with nvcc at first use

Tensors are NHWC at every public function, as in the JAX package. Only fp32
is ported so far.
"""

__version__ = "0.1.0"
