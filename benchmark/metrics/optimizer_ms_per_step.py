"""Device milliseconds a step of the operations launched in the
``step.optimizer`` span, from the profiled steps of ``harness/spans.py``."""

from harness import spans


def read(t):
    return spans.span_value(t, "step.optimizer", "device_ms")
