"""Device milliseconds a step of the convolution family (``families.json``:
cuDNN's kernels by name) in the traced window."""


def read(t):
    us = t.family_us("convolution")
    return us / t.steps / 1e3 if us > 0 else None
