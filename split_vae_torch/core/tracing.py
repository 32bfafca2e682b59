"""Spans and counters of the port: the one tracer of the package.

``span(name)`` marks a stretch of host time at a layer boundary (the loader,
the train step's phases, the optimizer, the metrics' drain). Tracing is off
by default, and then ``span`` returns one shared no-op context: it records
nothing and enters no ``torch.profiler.record_function``. With tracing on
(``enable(True)``) a span

- appends ``Span(name, parent, start_ns, end_ns)`` to an in-memory list,
  where ``parent`` is the enclosing span on this thread and the clock is
  ``time.perf_counter_ns``; ``drain()`` returns the list and clears it;
- enters ``torch.profiler.record_function(name)``, so a running profiler
  holds the span as a CPU event on the clock of its device events.

The package has no exporter of its own: ``core/logging.py::maybe_profile``
turns tracing on inside its block and writes the profiler's trace.

``count(name, n)`` adds to a counter whatever the tracing's state (one dict
update); ``counters()`` is a copy of them all. The kernels count their
launches here (``render.fwd``, ``render.bwd``, ``render_windowed.fwd``,
``render_windowed.bwd``, ``crop.fwd``, ``crop.bwd``); the train step its
path (``step.graphed``, ``step.eager``) and the batch shapes it recorded
under cuDNN's autotuner (``step.autotuned``, ``train/graphs.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

_on = False
_records: List["Span"] = []
_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()  # autograd's threads count the backward launches
_local = threading.local()


class Span(NamedTuple):
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int


class _Off:
    """The context every span is while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> List[str]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _On:
    __slots__ = ("name", "parent", "start", "mark")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.mark = torch.profiler.record_function(self.name)
        self.mark.__enter__()
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.mark.__exit__(*exc)
        _stack().pop()
        _records.append(Span(self.name, self.parent, self.start, end))
        return False


def span(name: str):
    """The context that marks a span ``name`` while tracing is on."""
    if not _on:
        return _OFF
    return _On(name)


def enable(on: bool) -> None:
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def drain() -> List[Span]:
    """The spans recorded since the last drain, in the order they ended."""
    global _records
    out, _records = _records, []
    return out


def count(name: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    with _counters_lock:
        return dict(_counters)


def self_ns(records: Iterable[Span]) -> List[int]:
    """Each span's self time: its duration less the part its child spans
    cover (spans of one thread, which nest)."""
    records = list(records)
    own = [r.end_ns - r.start_ns for r in records]
    order = sorted(range(len(records)), key=lambda i: (records[i].start_ns, -records[i].end_ns))
    open_: List[int] = []
    for i in order:
        r = records[i]
        while open_ and records[open_[-1]].end_ns <= r.start_ns:
            open_.pop()
        if open_ and records[open_[-1]].name == r.parent:
            own[open_[-1]] -= r.end_ns - r.start_ns
        open_.append(i)
    return own


def summary(records: Iterable[Span]) -> Dict[str, Dict[str, float]]:
    """Per span name: calls, total and self nanoseconds."""
    records = list(records)
    out: Dict[str, Dict[str, float]] = {}
    for r, own in zip(records, self_ns(records)):
        row = out.setdefault(r.name, {"calls": 0, "total_ns": 0, "self_ns": 0})
        row["calls"] += 1
        row["total_ns"] += r.end_ns - r.start_ns
        row["self_ns"] += own
    return out
