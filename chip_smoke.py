"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the LG-SPAIR train step at BASELINE config #5
(Multi-Bird-Hard: B=256, 48-px canvases, 4x4 cells, 32-px objects, full
widths, random weights from a seed), through the hand-written CUDA render
kernels. Phases, each of which must pass:

  1. the card's name and power limit, from nvidia-smi;
  2. build the kernels from split_vae_torch/csrc (nvcc, sm_90a), timed;
  3. each kernel against its plain PyTorch version on the card (TF32 off), at
     the config-#5 shapes and at an unaligned shape (30-px objects on 45-px
     canvases), with render noise 0 and 0.01: the forward at atol 3e-5, all
     six gradients at rtol 1e-3, atol 2e-4 (the TPU tests' tolerances);
  4. kernel and plain times at config #5 (median of CUDA-event timings);
  5. one small train step on the card against the same step on the CPU
     (plain render), then the main path: config-#5 train steps with the
     kernels' launch counts set to 0 before and read after, and a profile of
     three more steps (device time by kernel family, the device's idle share);
  6. one JSON line per run of kernels, then the card, then {"ok": true, ...}.

Exits non-zero, printing no result, without CUDA or without the repository
beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
FWD_ATOL = 3e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 2e-4
TRAIN_STEPS, WARMUP_STEPS = 8, 2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3):
    """Median milliseconds of fn() over reps runs, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def render_inputs(torch, b, grid, os_, canvas, c, seed):
    """Config-#5-like render inputs on the card: weights from random boxes."""
    from split_vae_torch.ops.stn import paste_interp_weights

    g = torch.Generator(device="cuda").manual_seed(seed)
    k = grid * grid
    objs = torch.rand((b, k, os_, os_, c + 1), generator=g, device="cuda")
    z_where = torch.randn((b, grid, grid, 4), generator=g, device="cuda")
    wy, wx, _ = paste_interp_weights(z_where, (canvas, canvas), (os_, os_))
    z_pres = torch.rand((b, k), generator=g, device="cuda")
    depth_w = torch.sigmoid(-torch.randn((b, k), generator=g, device="cuda")) + 0.5
    bg = torch.rand((b, canvas, canvas, c), generator=g, device="cuda")
    seed_t = torch.tensor([seed * 7919 + 1], dtype=torch.int32, device="cuda")
    return [objs, wy.contiguous(), wx.contiguous(), z_pres, depth_w, bg], seed_t


def compare_kernels(torch, render, shape, noise_scale, seed):
    """Kernel vs plain, forward and the six gradients; returns (fwd err, bwd err)."""
    b, grid, os_, canvas, c = shape
    args, seed_t = render_inputs(torch, b, grid, os_, canvas, c, seed)
    noise = None
    if noise_scale > 0:
        noise = noise_scale * render.render_noise(seed_t, b, grid * grid, c, canvas, canvas)
    ins_k = [a.clone().requires_grad_(True) for a in args]
    ins_p = [a.clone().requires_grad_(True) for a in args]
    out_k = render.fused_paste_render(*ins_k, seed_t, noise_scale)
    out_p = render.render_reference(*ins_p, noise)
    cot = torch.randn(out_k.shape, generator=torch.Generator(device="cuda").manual_seed(seed),
                      device="cuda")
    g_k = torch.autograd.grad(out_k, ins_k, cot)
    g_p = torch.autograd.grad(out_p, ins_p, cot)
    torch.cuda.synchronize()
    fwd_err = (out_k - out_p).abs().max().item()
    what = f"{shape} noise {noise_scale}"
    if not fwd_err <= FWD_ATOL:
        fail(f"render forward {what}: max |kernel - plain| {fwd_err:.3g} > {FWD_ATOL}")
    bwd_err = 0.0
    for name, a, p in zip(("objs", "wy", "wx", "z_pres", "depth_w", "bg"), g_k, g_p):
        err = (a - p).abs()
        excess = (err - (GRAD_ATOL + GRAD_RTOL * p.abs())).max().item()
        if not excess <= 0:
            fail(f"render backward {what}: d{name} max err {err.max().item():.3g} "
                 f"beyond rtol {GRAD_RTOL}, atol {GRAD_ATOL}")
        bwd_err = max(bwd_err, err.max().item())
    log(f"  {what}: forward max err {fwd_err:.3g}, gradients max err {bwd_err:.3g}")
    return fwd_err, bwd_err


def bounds(shape):
    """Least times (ms) for the forward and backward kernels at this shape.

    Bytes: each input read once, each output written once (fp32). Operations:
    the dense products the kernels do, 2 FLOP per multiply-add; the Philox
    noise and the elementwise composite are not counted.
    """
    b, grid, h, hh, c = shape
    k, c1, w, ww = grid * grid, c + 1, h, hh
    cells = b * k
    in_bytes = 4 * (cells * (h * w * c1 + hh * h + ww * w + 2) + b * hh * ww * c)
    img_bytes = 4 * b * hh * ww * c
    fwd_fma = cells * (c1 * h * ww * w + c1 * hh * ww * h)
    # The backward recomputes the two paste products, then gp.Wx, dWy, dobj,
    # Wy.obj and dWx: five more products per cell.
    bwd_fma = fwd_fma + cells * (c1 * hh * w * ww + c1 * hh * h * ww + c1 * h * w * hh
                                 + c1 * hh * w * h + ww * w * c1 * hh)
    out = {}
    for name, nbytes, fma in (("fwd", in_bytes + img_bytes, fwd_fma),
                              ("bwd", 2 * in_bytes + img_bytes, bwd_fma)):
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2 * fma / PEAK_FP32 * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
                     nbytes, 2 * fma)
    return out


def time_render(torch, render, shape, noise_scale):
    b, grid, os_, canvas, c = shape
    args, seed_t = render_inputs(torch, b, grid, os_, canvas, c, 11)
    noise = noise_scale * render.render_noise(seed_t, b, grid * grid, c, canvas, canvas)
    g = torch.rand((b, canvas, canvas, c), device="cuda")
    ins = [a.clone().requires_grad_(True) for a in args]
    out_p = render.render_reference(*ins, noise)
    return {
        "fwd": cuda_ms(lambda: render._fwd(*args, seed_t, noise_scale)),
        "bwd": cuda_ms(lambda: render._bwd(*args, seed_t, noise_scale, g)),
        "plain_fwd": cuda_ms(lambda: render.render_reference(*args, noise)),
        "plain_bwd": cuda_ms(lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True)),
    }


def kernel_family(name: str) -> str:
    """A coarse family for a CUDA kernel's name, for the step's breakdown."""
    low = name.lower()
    if "render_" in low:
        return "render kernels (this port)"
    if any(s in low for s in ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop",
                              "winograd", "fft")):
        return "convolutions (cuDNN)"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "matmul", "splitk")):
        return "matrix products (cuBLAS)"
    if "reduce" in low or "norm" in low:
        return "reductions"
    if "copy" in low or "memcpy" in low or "memset" in low or "cat" in low:
        return "copies"
    return "elementwise and other"


def profile_steps(torch, train_step, state, batch, steps: int = 3):
    """Device time by kernel family over a few train steps (torch.profiler).

    Returns the state, the window's host seconds, the union of the kernels'
    device intervals in seconds, and {family: (device seconds, launches)}.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:  # union of the kernels' intervals, in microseconds
        if e > end:
            busy += e - max(s, end)
            end = e
    families = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = families.get(kernel_family(e.name), (0.0, 0))
            families[kernel_family(e.name)] = (t + e.time_range.elapsed_us() * 1e-6, n + 1)
    return state, wall, busy * 1e-6, families


class RecordingNoise:
    """Draws like core.noise.Noise and keeps each draw, for a replay."""

    def __init__(self, noise):
        self.noise, self.drawn = noise, []

    def normal(self, shape):
        self.drawn.append(self.noise.normal(shape))
        return self.drawn[-1]

    def uniform(self, shape):
        self.drawn.append(self.noise.uniform(shape))
        return self.drawn[-1]

    def seed(self):
        return self.noise.seed()


def small_step_check(torch, np):
    """One small train step on the card (kernels) against the CPU (plain render).

    Held: the clipped gradients tensor by tensor (rtol 1e-3, atol 1e-6 max|g|),
    the step's metrics (rtol 1e-4), and the parameters after Adam (atol 1e-5)
    wherever the clipped gradient is at least 1e-5. Below that, Adam's first
    step -lr g / (|g| + 1e-7) turns the summation-order differences of a
    near-zero gradient (the card's convolutions add in another order than the
    CPU's, and not the same order from run to run) into update differences of
    up to lr, so there only the gradient is held.
    """
    from split_vae_torch.core.config import config5
    from split_vae_torch.core.noise import Noise
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.ops.patches import augment_batch, scramble_shape
    from split_vae_torch.train.losses import spair_loss
    from split_vae_torch.train.optim import clip_by_per_tensor_norm, spair_optimizer
    from split_vae_torch.train.steps import make_spair_train_step

    cfg = config5(batch_size=4, latent_size=8, bg_latent_size=8, local_latent_size=8,
                  object_size=16)
    cfg.image_size = (24, 24, 3)
    x = torch.from_numpy(np.random.RandomState(1).uniform(0, 1, (4, 24, 24, 3)).astype(np.float32))
    cpu = get_spair_model(cfg, device="cpu")
    gpu = get_spair_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    for m in (cpu, gpu):
        m.render_noise_scale = 0.0
    gen = torch.Generator().manual_seed(2)
    u = torch.rand(scramble_shape(x.shape, cfg.patch_size), generator=gen)
    rec = RecordingNoise(Noise(gen))
    with torch.no_grad():
        cpu(augment_batch(x, "scramble", cfg.patch_size, u=u), True, rec)
    replay = [u] + rec.drawn

    grads = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        images = augment_batch(x.to(dev), "scramble", cfg.patch_size, u=u.to(dev))
        out = model(images, True, Noise(torch.Generator(device=dev), rec.drawn))
        total, _ = spair_loss(out, images, cfg, 0, training=True)
        g = torch.autograd.grad(total, list(model.parameters()))
        grads.append([t.cpu() for t in clip_by_per_tensor_norm(1.0).update(list(g), ())[0]])
    names = [n for n, _ in cpu.named_parameters()]
    worst_g = 0.0
    for name, gc, gg in zip(names, *grads):
        excess = ((gg - gc).abs() - (1e-3 * gc.abs() + 1e-6 * gc.abs().max())).max().item()
        if not excess <= 0:
            fail(f"small step: gradient of {name} differs by {(gg - gc).abs().max().item():.3g}"
                 f" (max |g| {gc.abs().max().item():.3g})")
        worst_g = max(worst_g, ((gg - gc).abs().max() / gc.abs().max()).item())

    results = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        state = create_train_state(model, spair_optimizer(cfg.learning_rate), seed=0)
        state, metrics = make_spair_train_step(cfg)(state, x.to(dev),
                                                    [t.to(dev) for t in replay])
        results.append(({k: float(v) for k, v in metrics.items()},
                        [p.detach().cpu() for p in model.parameters()]))
    (m_cpu, p_cpu), (m_gpu, p_gpu) = results
    for k in m_cpu:
        if not abs(m_gpu[k] - m_cpu[k]) <= 1e-4 * abs(m_cpu[k]) + 1e-6:
            fail(f"small step: metric {k} card {m_gpu[k]} vs CPU {m_cpu[k]}")
    worst = 0.0
    for name, pc, pg, gc in zip(names, p_cpu, p_gpu, grads[0]):
        diff = torch.where(gc.abs() >= 1e-5, (pg - pc).abs(), torch.zeros_like(pc))
        worst = max(worst, diff.max().item())
        if not worst <= 1e-5:
            fail(f"small step: {name} after Adam differs by {worst:.3g} > 1e-5")
    log(f"  small step (B=4, 24 px): clipped gradients within {worst_g:.3g} max|g|, metrics "
        f"within rtol 1e-4 of the CPU step, params after Adam within {worst:.3g}")


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "split_vae_torch")):
        fail("split_vae_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from split_vae_torch.core.config import config5
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.kernels import render
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.optim import spair_optimizer
    from split_vae_torch.train.steps import make_spair_train_step, use_fp32

    # Phase 1: the card.
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_fp32()

    # Phase 2: build.
    t0 = time.perf_counter()
    lib = render.build()
    log(f"build: nvcc sm_90a in {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib, HERE)}")
    with open(lib[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    # Phase 3: kernels against the plain version.
    cfg5_shape = (256, 4, 32, 48, 3)  # B, grid, object size, canvas, colour channels
    log("kernel vs plain (fp32, TF32 off):")
    errs = {"fwd": 0.0, "bwd": 0.0}
    for i, (shape, noise) in enumerate(((cfg5_shape, 0.0), (cfg5_shape, 0.01),
                                        ((8, 4, 30, 45, 3), 0.0), ((8, 4, 30, 45, 3), 0.01))):
        fe, be = compare_kernels(torch, render, shape, noise, seed=i + 1)
        errs["fwd"], errs["bwd"] = max(errs["fwd"], fe), max(errs["bwd"], be)
    # The CPU path draws the same noise field with a numpy twin of the kernels'
    # Philox; the two agree up to the float32 math libraries (log, cos, sqrt).
    seed_t = torch.tensor([12345], dtype=torch.int32, device="cuda")
    noise_err = (render.render_noise(seed_t, 2, 16, 3, 45, 45).cpu()
                 - render.render_noise(seed_t.cpu(), 2, 16, 3, 45, 45)).abs().max().item()
    if not noise_err <= 1e-5:
        fail(f"render noise: card field vs the CPU's numpy twin, max err {noise_err:.3g} > 1e-5")
    log(f"  render noise: card field vs the CPU's numpy twin, max err {noise_err:.3g}")

    # Phase 4: times at config #5, with the main path's noise 0.01.
    times = time_render(torch, render, cfg5_shape, 0.01)
    bound = bounds(cfg5_shape)
    for name in ("fwd", "bwd"):
        t, by, nbytes, flops = bound[name]
        log(f"render {name}: kernel {times[name]:.4f} ms, plain {times['plain_' + name]:.4f} ms, "
            f"bound {t:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")

    # Phase 5: a small step against the CPU, then the main path.
    small_step_check(torch, np)
    cfg = config5()
    model = get_spair_model(cfg, device="cuda")
    state = create_train_state(model, spair_optimizer(cfg.learning_rate), seed=cfg.seed)
    train_step = make_spair_train_step(cfg)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.uniform(0, 1, (cfg.batch_size, 48, 48, 3))
                                .astype(np.float32)).cuda() for _ in range(2)]
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    render.fwd_launches = render.bwd_launches = 0
    losses = []
    for i in range(WARMUP_STEPS):
        state, metrics = train_step(state, batches[i % 2])
        losses.append(metrics["total_loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state, metrics = train_step(state, batches[i % 2])
        losses.append(metrics["total_loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {"fwd": render.fwd_launches, "bwd": render.bwd_launches}
    steps = WARMUP_STEPS + TRAIN_STEPS
    losses = [v.item() for v in losses]
    log(f"train: LG-SPAIR config #5, B={cfg.batch_size}, {n_params} params, {steps} steps; "
        f"losses {losses[0]:.2f} -> {losses[-1]:.2f}; notfinite_updates "
        f"{int(metrics['notfinite_updates'].item())}")
    log(f"train: step {step_s * 1e3:.3f} ms, {cfg.batch_size / step_s:.1f} imgs/s "
        f"(mean of {TRAIN_STEPS} steps after {WARMUP_STEPS} warm-up)")
    if not all(np.isfinite(losses)):
        fail(f"train: non-finite loss {losses}")
    for name, n in launches.items():
        if n < steps:
            fail(f"train: render {name} kernel launched {n} times in {steps} steps")
    log(f"train: render kernel launches fwd {launches['fwd']}, bwd {launches['bwd']}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Where the step's time goes (after the counts were read).
    n_prof = 3
    state, wall, busy, families = profile_steps(torch, train_step, state, batches[0], n_prof)
    if busy > 0:
        log(f"profile: {n_prof} steps under torch.profiler, {wall / n_prof * 1e3:.3f} ms a step "
            f"on the host clock; device busy {busy / wall:.1%}, idle {1 - busy / wall:.1%}")
        for fam, (t, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
            log(f"  {fam}: {t / n_prof * 1e3:.3f} ms a step, {n // n_prof} launches a step")
    else:
        log("profile: the profiler recorded no device time")

    # Phase 6: the record.
    kernels = []
    for name, body in (("fwd", 87), ("bwd", 124)):
        t, by, _, _ = bound[name]
        kernels.append({
            "name": f"render_{name}", "route": "cuda",
            "source": "split_vae_torch/csrc/render.cu",
            "replaces": f"split_vae_tpu/ops/pallas/render_packed.py:{body}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": times[name], "kernel_ms": times[name], "plain_ms": times["plain_" + name],
            "bound_ms": t, "bound_by": by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
