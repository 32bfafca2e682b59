"""The benchmark of the PyTorch port of SPLIT (``split_vae_torch``): one cell,
one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the dataset and the weights from the seed on the card, builds
the port's training step, drives it through its checked steps and a few
warm-up steps, and counts all of that as ``setup_s``. The window then runs
the training loop's body for ``--seconds`` (``harness/window.py``). With
``--trace 1`` a few more steps run under the profiler and the cell's
per-layer readers (``metrics/<name>.py``) take their numbers from them.
Then the program is freed and the frozen reference takes the checked steps
(``harness/check.py``); ``correct`` says whether every number of the
comparison is within the cell's limit.

The last line of standard output is the result, one JSON object; the lines
before it give the card's readings around the window. The last lines of
standard error give each number compared beside its limit. Exits non-zero,
with no result, without a card (or with fewer than the cell asks for), and
when the process holds JAX or the JAX package after the window.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# Every build and kernel cache at a fixed path inside the checkout.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(CACHE, _sub)
for _path in (ROOT, HERE):
    if _path not in sys.path:
        sys.path.insert(0, _path)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "split_vae_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """JAX and the JAX package among the loaded modules, by top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def quarters(values):
    n = len(values)
    return [values[i * n // 4:(i + 1) * n // 4] or values for i in range(4)]


def reader(root: str, name: str):
    """The reader of per-layer metric ``name``: ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_layers(cell, tr) -> dict:
    """The cell's per-layer metrics from their readers; a reader that finds
    nothing to read gives None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = reader(cell.root, m["name"]).read(tr)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, device=None, root: str = ROOT, plant=None) -> int:
    """One run. ``device`` None takes the card (the benchmark's only way);
    the harness's own tests pass the CPU, a ``root`` of their own and a
    ``plant`` that breaks the step."""
    args = parse(argv)
    import torch

    from harness import card, check, data, port, spec, trace, window

    cell = spec.load_cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
                  f"this machine has {have}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    traffic = cell.traffic

    seeds = data.derive(args.seed)
    images = data.make_images(cell.config["dataset"], seeds.data, device)
    prog = port.build(cell, images, seeds.state, seeds.loader, device)
    weights = check.make_weights(cell, seeds, device)
    prog.load(weights)
    draws = check.step_draws(cell, seeds, check.batch_shape(cell), device)
    readings = check.program_steps(prog, weights, draws, plant)
    del weights, draws
    for _ in range(traffic["warmup_steps"]):
        prog.window_step()
    window.sync(device)
    gc.collect()
    before = card.smi(device.index or 0) if device.type == "cuda" else "cpu"
    load_before = os.getloadavg()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T0

    win = window.run(prog, args.seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traced = trace.record(prog, traffic["profile_steps"], device) if args.trace else None
    after = card.smi(device.index or 0) if device.type == "cuda" else "cpu"
    load_after = os.getloadavg()

    del prog  # the program's state and its resident dataset
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.reference_steps(cell, seeds, images, device, count_flops=bool(args.trace))
    numbers = check.compare(readings, ref)
    limits = cell.own["limits"]
    correct = check.verdict(numbers, limits)

    dev = card.describe(device, cell.chips, peak)
    result = {"correct": correct, "attempted": win.steps, "failed": win.skipped}
    if args.trace:
        dev_ops, host_ops, traced_s = traced
        tr = trace.Trace(steps=traffic["profile_steps"], device_ops=dev_ops, host_ops=host_ops,
                         step_s=win.step_s, cell=cell,
                         families=spec.load_json(os.path.join(HERE, "families.json")),
                         peaks=spec.load_json(os.path.join(HERE, "peaks.json")),
                         flops_per_step=ref.flops)
        result["metrics"] = read_layers(cell, tr)
        dev.update(busy_s=tr.busy_s(), window_s=traced_s)
        result["breakdown"] = {"device_ops": trace.top_ops(dev_ops),
                               "idle_gaps": trace.idle_gaps(dev_ops, host_ops)}
    else:
        e2e = {"train_imgs_per_s": win.steps * traffic["batch_size"] / win.seconds,
               "step_ms_p95": window.p95(win.step_ms), "peak_mem_gib": peak / 2**30,
               "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = dev
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}

    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)} after the window",
              file=sys.stderr)
        return 4
    print(f"card before the window: {before}; host load {load_before}")
    print(f"card after the window: {after}; host load {load_after}")
    q = statistics.quantiles(win.step_ms, n=20) if win.steps > 1 else win.step_ms * 19
    print(f"window: {win.steps} steps in {win.seconds:.6f} s; step ms p5 {q[0]:.3f}, p25 "
          f"{q[4]:.3f}, median {q[9]:.3f}, p75 {q[14]:.3f}, p95 {q[18]:.3f}; mean step ms by "
          f"quarter of the window {[round(statistics.fmean(p), 3) for p in quarters(win.step_ms)]}; "
          f"collector {win.gc_passes} passes in {win.gc_ms:.3f} ms; setup {setup_s:.3f} s; losses of the "
          f"checked steps {readings.losses} (reference {ref.losses})")
    for k in limits:
        print(f"check {k}: {numbers[k]!r} limit {limits[k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
