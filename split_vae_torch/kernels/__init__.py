"""Hand-written CUDA kernels: wrappers, launch counts and plain versions."""
