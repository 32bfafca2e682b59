"""Device milliseconds a step of the operations launched in the ``step.loss``
span (the losses' forward; their backward falls in ``step.backward``), from
the profiled steps of ``harness/spans.py``."""

from harness import spans


def read(t):
    return spans.span_value(t, "step.loss", "device_ms")
