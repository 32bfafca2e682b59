"""Conversion of JAX (flax) parameter trees into the port's state_dicts."""
