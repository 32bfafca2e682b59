"""Data-parallel training over processes, one a GPU (split_vae_tpu/parallel)."""
