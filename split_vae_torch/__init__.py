"""SPLIT on PyTorch and CUDA: the port of ``split_vae_tpu`` to one NVIDIA H100.

The JAX package ``split_vae_tpu`` stays the reference; this package runs the
same models in PyTorch, with the TPU's Pallas kernels rewritten by hand as
CUDA kernels for Hopper (``sm_90a``). Nothing here imports JAX.

Layout (mirrors the JAX package where a counterpart exists):
  core/      configs, train state, checkpoints, metrics, run logging, the
             noise source of a stochastic forward
  data/      SVHN, CelebA and MultiCUB, the batch streams
  ops/       distributions, STN, patch scramble and the other augmentations,
             count prior
  nn/        layers, the VAE and SPAIR networks, the probe classifier
  models/    LGVae, LGGMVae, GMVae; SPAIR, BG-SPAIR, LG-SPAIR,
             LGGlimpseSPAIR and their factory
  train/     losses, schedules, optimizer, the train and eval steps, the
             loops, the probes
  parallel/  data and tensor parallelism, one process a GPU
  viz/       the evals' PNGs
  cli/       the training CLIs
  interop/   flax parameter trees -> torch state_dicts
  kernels/   Python wrappers of the CUDA kernels, with their plain versions
  csrc/      CUDA sources, built with nvcc at first use
  utils/     small helpers

Tensors are NHWC at every public function, as in the JAX package. Every
Dense and Conv computes in float32 or, with ``--compute_dtype bfloat16``, in
bfloat16; the parameters and the optimizer's state stay float32.
"""

__version__ = "0.1.0"
