"""Host milliseconds a step in the loader's ``loader.next`` span (the slice,
the ``index_select``; a new epoch's permutation and its upload in
``loader.epoch`` within it), from the spans phase (``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.span_value(t, "loader.next", "host_ms")
