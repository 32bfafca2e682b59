"""The measured window: the training loop's body, step after step, for a set
number of seconds.

Each step's end is marked by a CUDA event on the stream; the events are read
after the window, which ends in ``torch.cuda.synchronize()``, so nothing in
the window waits for the device but what the program itself waits for. The
collector's passes in the window are counted. On the CPU (the harness's own
tests only) the host clock stands in for the events.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch


@dataclass
class Window:
    steps: int
    seconds: float          # host clock, from the first step's start to the synchronize
    step_ms: List[float]    # each step's interval between consecutive step-end marks
    gc_passes: int
    gc_ms: float
    skipped: int            # updates skipped as non-finite in the window

    @property
    def step_s(self) -> float:
        return self.seconds / self.steps


def p95(values) -> float:
    """The 95th percentile, linear between the order statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


class GcPasses:
    """Counts the garbage collector's passes and their time while the block lasts."""

    def __enter__(self):
        self.passes, self.seconds, self._t = 0, 0.0, 0.0
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.passes += 1
            self.seconds += time.perf_counter() - self._t

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        return False


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(prog, seconds: float, device) -> Window:
    """Window steps of ``prog`` until ``seconds`` have passed on the host clock."""
    cuda = device.type == "cuda"
    skipped0 = prog.skipped()
    marks = []
    sync(device)
    with GcPasses() as gcp:
        t0 = time.perf_counter()
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(t0)
        while True:
            prog.window_step()
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            else:
                marks.append(time.perf_counter())
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        wall = time.perf_counter() - t0
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return Window(len(step_ms), wall, step_ms, gcp.passes, gcp.seconds * 1e3,
                  prog.skipped() - skipped0)
