"""Run directories, console + JSONL logging, profiling hooks
(split_vae_tpu/core/logging.py).

Every metrics interval lands in ``<run_dir>/metrics.jsonl`` as
``{"step", "time", "<prefix><key>": float}`` (the JAX package's layout) and is
printed; ``maybe_profile`` writes a ``torch.profiler`` trace of a block, with
the port's spans in it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from datetime import datetime
from typing import Dict, Optional

import torch

from split_vae_torch.core import tracing


def make_run_dir(output_dir: str) -> str:
    """output/<YYYYmmdd-HHMMSS>/ like the reference (vae/trainer.py:73-80).

    Names have second resolution; back-to-back runs in one process (--runs,
    fast tests) can start within the same second, and sharing a run dir would
    interleave their metrics.jsonl. A ``-N`` suffix dedupes; creation is
    exclusive so concurrent processes cannot collide.
    """
    base = datetime.now().strftime("%Y%m%d-%H%M%S")
    for i in range(1, 1000):
        run_name = base if i == 1 else f"{base}-{i}"
        run_dir = os.path.join(output_dir, run_name)
        try:
            os.makedirs(run_dir)
        except FileExistsError:
            continue
        return run_dir
    raise RuntimeError(f"could not allocate a run dir under {output_dir}")


class RunLogger:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        record = {"step": step, "time": time.time()}
        record.update({(prefix + k): float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        shown = ", ".join(f"{k}: {v:.4f}" for k, v in metrics.items())
        print(f"[step {step}] {prefix}{shown}")

    def close(self) -> None:
        self._jsonl.close()


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], step: int):
    """A torch.profiler trace of this block, written to
    ``<profile_dir>/step_<step>/trace.json``, when profile_dir is set. The
    port's tracing is on inside the block, so the trace holds its spans
    (``core/tracing.py``) above the device's rows."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = tracing.enabled()
    tracing.enable(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        tracing.enable(was_on)
        if not was_on:
            tracing.drain()
    out = os.path.join(profile_dir, f"step_{step}")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


class StepTimer:
    """imgs/sec over an interval, the device synchronized before the clock is read."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.images = 0

    def add(self, n: int):
        self.images += n

    def rate(self, sync_value: Optional[torch.Tensor] = None) -> float:
        if sync_value is not None and sync_value.is_cuda:
            torch.cuda.synchronize(sync_value.device)
        dt = time.perf_counter() - self.t0
        return self.images / dt if dt > 0 else 0.0
