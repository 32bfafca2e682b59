"""Layers with the JAX package's conventions and the SPAIR networks."""
