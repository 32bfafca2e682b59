"""Device milliseconds a step of the operations launched in the GM encoder's
forward: the ``forward.gm_encoder`` span and the ``gm.y`` span inside it
(each operation goes to the innermost span open at its launch, so the two
add up to the encoder's forward; its backward falls in ``step.backward``),
from the profiled steps of ``harness/spans.py``. None where the program has
neither span."""

from harness import spans


def read(t):
    encoder = spans.span_value(t, "forward.gm_encoder", "device_ms")
    if encoder is None:
        return None
    return encoder + (spans.span_value(t, "gm.y", "device_ms") or 0.0)
