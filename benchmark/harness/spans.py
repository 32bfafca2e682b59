"""The port's spans in a traced run: the host time of each of the program's
layers, and the device time and idle time charged to them.

The port marks its layers with spans (``split_vae_torch/core/tracing.py``:
the loader, the train step's phases, the optimizer, the metrics' drain).
``trace.record`` keeps the ``aten::`` host operators of its window only, and
a process that has run ``torch.profiler`` steps about a fifth slower after it
(PERF.md, section 5), so the span readers (``metrics/loader_ms_per_step.py``
and the four beside it) take their numbers from a process of their own,
started once a run by ``reading`` after the output check. It builds the
program again from the run's seed and runs:

- warm-up: the traffic's ``warmup_steps``, tracing off;
- the spans phase: blocks of window steps without the profiler, tracing off
  and on in turns (off, on, on, off, so that a drift over the phase cancels;
  each block at least ``profile_steps`` steps and a second of the window's
  steps). The host times read the on blocks; the off blocks give the
  tracing's cost;
- profiled steps: ``profile_steps`` window steps under ``torch.profiler``
  with the port's tracing on. A device operation belongs to the innermost
  span open on the host when the host launched it: the launch is the
  runtime call that carries the operation's correlation id. Backward
  kernels, launched from autograd's thread while the main thread waits in
  ``step.backward``, go by that time too. An operation launched outside
  every span counts as ``(outside spans)``. An idle gap between two busy
  stretches of the device is charged to the span open when it began.

``reading`` prints the whole of it as one ``spans:`` line of JSON, per step:
for each span its calls, its host ms in all and of its own (less its child
spans), the device ms launched in it and the idle ms charged to it.
Where the program has no spans (a checkout before them), or the traced
window saw no device, it gives None and the readers leave their metrics out.

    python3 benchmark/harness/spans.py --workload <cell> --seed <n> --step_s <s>

runs the phases alone and prints the reading as its last line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path[:0] = [p for p in (ROOT, HERE) if p not in sys.path]

import torch  # noqa: E402

OUTSIDE = "(outside spans)"
UNLINKED = "(launch not found)"

Interval = Tuple[str, float, float]          # (name, start, end)
DeviceOp = Tuple[str, float, float, int]     # (name, start, end, correlation id)

_cache: Dict[str, Optional[dict]] = {}


def innermost(spans: List[Interval], times: List[float]) -> List[Optional[str]]:
    """The innermost span open at each of ``times``: spans nest (one
    thread's), a span holds [start, end)."""
    events = []
    for i, (_, s, e) in enumerate(spans):
        events.append((s, 1, i))
        events.append((e, 0, i))
    for j, t in enumerate(times):
        events.append((t, 2, j))
    events.sort()
    out: List[Optional[str]] = [None] * len(times)
    open_: List[int] = []
    for _, kind, i in events:
        if kind == 1:
            open_.append(i)
        elif kind == 0:
            if open_ and open_[-1] == i:
                open_.pop()
            elif i in open_:
                open_.remove(i)
        else:
            out[i] = spans[open_[-1]][0] if open_ else None
    return out


def device_by_span(spans: List[Interval], launches: Dict[int, float],
                   ops: List[DeviceOp]) -> Dict[str, float]:
    """Device time of ``ops`` by the innermost span open at each one's
    launch (``launches``: correlation id -> the host time of its launch)."""
    linked = [(op, launches[op[3]]) for op in ops if op[3] in launches]
    names = innermost(spans, [t for _, t in linked])
    out: Dict[str, float] = {}
    for (op, _), name in zip(linked, names):
        key = name or OUTSIDE
        out[key] = out.get(key, 0.0) + (op[2] - op[1])
    missing = sum(e - s for _, s, e, c in ops if c not in launches)
    if missing:
        out[UNLINKED] = missing
    return out


def busy(ops) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, as sorted disjoint pairs."""
    out: List[List[float]] = []
    for s, e in sorted((op[1], op[2]) for op in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_by_span(spans: List[Interval], ops) -> Dict[str, float]:
    """The device's idle gaps between busy stretches, each charged to the
    innermost span open on the host when it began."""
    stretches = busy(ops)
    gaps = [(a[1], b[0] - a[1]) for a, b in zip(stretches, stretches[1:]) if b[0] > a[1]]
    out: Dict[str, float] = {}
    for (_, length), name in zip(gaps, innermost(spans, [s for s, _ in gaps])):
        key = name or OUTSIDE
        out[key] = out.get(key, 0.0) + length
    return out


def from_profile(prof, names) -> Tuple[List[Interval], Dict[int, float], List[DeviceOp]]:
    """(the spans ``names`` as host intervals, launch times by correlation id,
    device operations) of a finished ``torch.profiler.profile``, all in
    nanoseconds on the profiler's clock."""
    spans, launches, ops = [], {}, []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and e.name() not in names:
                ops.append((e.name(), start, end, e.correlation_id()))
        elif e.is_user_annotation():
            if e.name() in names:
                spans.append((e.name(), start, end))
        elif e.correlation_id() and e.name().startswith("cu"):
            launches[e.correlation_id()] = start  # cudaLaunchKernel, cudaMemcpyAsync, ...
    return spans, launches, ops


def _run_seed(default: int = 0) -> int:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--seed", type=int, default=default)
    return p.parse_known_args(sys.argv[1:])[0].seed


def _steps(prog, n: int, device) -> float:
    """Seconds of ``n`` window steps, from a synchronized device to the next."""
    from harness import window
    window.sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        prog.window_step()
    window.sync(device)
    return time.perf_counter() - t0


def measure(cell, seed: int, device, step_s: float, blocks: int = 2,
            block_s: float = 1.0) -> dict:
    """The spans reading of ``cell`` on ``device`` (see the module's doc)."""
    from torch.profiler import ProfilerActivity, profile

    from harness import data, port
    from split_vae_torch.core import tracing

    traffic = cell.traffic
    seeds = data.derive(seed)
    images = data.make_images(cell.config["dataset"], seeds.data, device)
    prog = port.build(cell, images, seeds.state, seeds.loader, device)
    del images
    n_prof = traffic["profile_steps"]
    n_block = max(n_prof, math.ceil(block_s / max(step_s, 1e-6)))
    on_s, off_s, records = 0.0, 0.0, []
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    was_on = tracing.enabled()
    try:
        tracing.enable(False)
        for _ in range(traffic["warmup_steps"]):
            prog.window_step()
        counted0 = tracing.counters()
        for i in range(blocks):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                tracing.enable(on)
                took = _steps(prog, n_block, device)
                if on:
                    on_s += took
                    records += tracing.drain()
                else:
                    off_s += took
        counted1 = tracing.counters()
        tracing.enable(True)
        with profile(activities=activities) as prof:
            _steps(prog, n_prof, device)
        names = {r.name for r in records + tracing.drain()}
    finally:
        tracing.enable(was_on)
        tracing.drain()
    del prog
    gc.collect()

    spans, launches, ops = from_profile(prof, names)
    n_on = blocks * n_block
    ms = 1e-6  # nanoseconds to milliseconds
    table: Dict[str, dict] = {}
    for name, row in tracing.summary(records).items():
        table[name] = {"calls": row["calls"] / n_on, "host_ms": row["total_ns"] * ms / n_on,
                       "self_ms": row["self_ns"] * ms / n_on, "device_ms": 0.0, "idle_ms": 0.0}
    for key, field in ((device_by_span(spans, launches, ops), "device_ms"),
                       (idle_by_span(spans, ops), "idle_ms")):
        for name, ns in key.items():
            table.setdefault(name, {"device_ms": 0.0, "idle_ms": 0.0})[field] = ns * ms / n_prof
    return {
        "spans": table,
        "profiled_steps": n_prof, "spans_steps": n_on,
        "profiled_spans": len(spans) / n_prof,
        "device_ms": sum(e - s for _, s, e, _ in ops) * ms / n_prof,
        "step_ms": on_s * 1e3 / n_on, "step_ms_tracing_off": off_s * 1e3 / n_on,
        "counters": {k: (v - counted0.get(k, 0)) / n_on for k, v in counted1.items()
                     if v != counted0.get(k, 0)},
    }


def run_alone(cell, seed: int, step_s: float, device: str = "cuda",
              timeout_s: float = 900.0) -> dict:
    """``measure`` in a process of its own (this file as a script)."""
    cmd = [sys.executable, os.path.abspath(__file__), "--workload", cell.name, "--root",
           cell.root, "--seed", str(seed), "--step_s", repr(step_s), "--device", device]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, cwd=cell.root)
    if out.returncode != 0:
        raise RuntimeError(f"exit {out.returncode}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def reading(t) -> Optional[dict]:
    """The run's spans reading (computed at the first call, then kept), or
    None where there is nothing to read."""
    key = t.cell.name
    if key in _cache:
        return _cache[key]
    _cache[key] = None
    if not t.device_ops or importlib.util.find_spec("split_vae_torch.core.tracing") is None:
        return None
    try:
        got = run_alone(t.cell, _run_seed(), t.step_s)
    except (RuntimeError, subprocess.TimeoutExpired, ValueError, IndexError):
        # the result line stands without these metrics
        print("spans: the spans phase failed:\n" + traceback.format_exc(), file=sys.stderr)
        return None
    got["window_step_ms"] = t.step_s * 1e3
    print("spans: " + json.dumps(got), flush=True)
    _cache[key] = got
    return got


def span_value(t, span: str, field: str) -> Optional[float]:
    """``field`` of ``span`` in the run's reading, per step; None where absent."""
    got = reading(t)
    row = (got or {}).get("spans", {}).get(span)
    if row is None or field not in row:
        return None
    return row[field]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The spans phase of one cell, alone.")
    p.add_argument("--workload", required=True)
    p.add_argument("--root", default=ROOT)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--step_s", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from harness import spec
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    got = measure(spec.load_cell(args.workload, args.root), args.seed, device, args.step_s)
    print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
