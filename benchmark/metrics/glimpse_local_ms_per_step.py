"""Device milliseconds a step of the operations launched in LGGlimpseSPAIR's
glimpse-local forward: the ``forward.glimpse_local`` span (the patch
scramble and the local head of ``ObjEncoderScramble``) and the
``forward.glimpse_decode`` span (``GlimpseDecoder``), from the profiled
steps of ``harness/spans.py``. Their backward falls in ``step.backward``.
None where the program has neither span."""

from harness import spans


def read(t):
    parts = [spans.span_value(t, name, "device_ms")
             for name in ("forward.glimpse_local", "forward.glimpse_decode")]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
