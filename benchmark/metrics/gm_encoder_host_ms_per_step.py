"""Host milliseconds a step inside the GM encoder's ``forward.gm_encoder``
span (its ``gm.y`` span included), from the spans phase
(``harness/spans.py``). None where the program has no such span."""

from harness import spans


def read(t):
    return spans.span_value(t, "forward.gm_encoder", "host_ms")
