"""The traced window: a few steps of the loop's body under ``torch.profiler``,
after the unprofiled window of the same run, reduced to what the per-layer
readers take.

Device operations are the trace's CUDA events: kernels, memcpys, memsets.
The device is busy in the union of their intervals. An idle gap is a stretch
between two busy stretches; it is named by the host operator that was
running when it began (the innermost ``aten::`` operator whose interval holds
its start).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from . import window

Interval = Tuple[str, float, float]  # (name, start, end), microseconds
NAME_CHARS = 160  # of an operation's name in the breakdown: templated kernels run to thousands


@dataclass
class Trace:
    """What a per-layer reader reads: the traced steps' device operations,
    the unprofiled window's step time, the cell's files."""

    steps: int
    device_ops: List[Interval]
    host_ops: List[Interval]
    step_s: float           # the unprofiled window's seconds a step, same run
    cell: object = None     # spec.Cell
    families: List = field(default_factory=list)
    peaks: Dict = field(default_factory=dict)
    flops_per_step: Optional[float] = None

    def busy_s(self) -> float:
        return sum(e - s for s, e in union(self.device_ops)) * 1e-6

    def family_of(self, name: str) -> str:
        low = name.lower()
        for family, patterns in self.families:
            if any(p in low for p in patterns):
                return family
        return "other"

    def family_us(self, family: str) -> float:
        return sum(e - s for n, s, e in self.device_ops if self.family_of(n) == family)

    def named_us(self, patterns) -> float:
        """Device microseconds of the operations whose name matches one of the
        regular expressions ``patterns``."""
        regs = [re.compile(p) for p in patterns]
        return sum(e - s for n, s, e in self.device_ops if any(r.search(n) for r in regs))


def union(ops: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals, as sorted disjoint (start, end) pairs."""
    out: List[List[float]] = []
    for s, e in sorted((s, e) for _, s, e in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(ops: List[Interval], host: List[Interval], top: int = 10):
    """The ``top`` longest idle gaps between busy stretches, as [host operator,
    seconds]."""
    busy = union(ops)
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]),
                  reverse=True)[:top]
    named = []
    for length, start in gaps:
        inside = [(s, n) for n, s, e in host if s <= start < e]
        named.append([max(inside)[1][:NAME_CHARS] if inside else "(host between operators)",
                      length * 1e-6])
    return named


def top_ops(ops: List[Interval], top: int = 10):
    """The ``top`` device operations by total time, as [name, seconds]."""
    totals: Dict[str, float] = {}
    for n, s, e in ops:
        totals[n] = totals.get(n, 0.0) + (e - s)
    return [[n[:NAME_CHARS], t * 1e-6]
            for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def record(prog, steps: int, device) -> Tuple[List[Interval], List[Interval], float]:
    """``steps`` window steps under the profiler: (device ops, host ops, seconds)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    window.sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            prog.window_step()
        window.sync(device)
        seconds = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(item)
        elif e.name.startswith("aten::"):
            host.append(item)
    return dev, host, seconds
