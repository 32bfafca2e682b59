"""Host milliseconds a step in the ``step.optimizer`` span (the clip, Adam and
the non-finite skip of ``train/optim.py``, the parameters' update), from the
spans phase (``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.span_value(t, "step.optimizer", "host_ms")
