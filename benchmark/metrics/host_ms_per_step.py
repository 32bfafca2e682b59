"""Host milliseconds a step inside the train step's ``step`` span, enqueueing
or waiting on the device, from the spans phase (``harness/spans.py``):
against the unprofiled step, the share of the step the host spends in it."""

from harness import spans


def read(t):
    return spans.span_value(t, "step", "host_ms")
