"""Checks of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent CHECKOUT]

Drives the port's main paths at full width (random weights from a seed) and
checks what they compute; it times no path, which ``benchmark/`` does. The
paths: SPAIR-family train steps (B=256, 48-px canvases, 4x4 cells) through
the hand-written CUDA kernels (the fused paste+composite render, full-canvas
and row-windowed, and the STN glimpse crop), and the VAE-family train steps
(LGVae, LGGMVae), which have no hand-written kernel on them:

  P1  LG-SPAIR at BASELINE config #5 (Multi-Bird-Hard: 32-px objects, dense
      background and local paths);
  P2  BG-SPAIR at the SpairConfig defaults (32-px objects);
  P3  LGGlimpseSPAIR with 28-px objects in 4-px patches, the shapes that are
      not multiples of 8 (its step graphed like the others: the patch
      permutation is a static draw), one glimpse scramble a step;
  P4  P1's configuration, model and seed with the row-windowed render
      selected in place of the full-canvas one;
  P5  LGVae (SPLIT-VAE) at BASELINE config #2 (CelebA 64x64, B=64, patch 8,
      latents 128/128), uint8 batches;
  P6  config #5 through the CLI, split_vae_torch.cli.spair_main.main with the
      reference command's flags and -synthetic_data (2048 MultiCUB canvases
      made by the native generator, two test splits of 256): 40 steps with
      evals and checkpoints every 20, then --resume to step 60;
  P7  config #2 through split_vae_torch.cli.vae_main.main (synthetic CelebA
      64x64), the same schedule;
  P8  LGGMVae (SPLIT-GMVAE) at BASELINE config #3 (SVHN 32x32, B=64, latents
      128/128, y_size 30, tau 0.4, beta 40, alpha 40, patch 4), uint8 batches;
  P9  config #3 through the CLIs: split_vae_torch.cli.classifier_main (one
      epoch on synthetic data), then vae_main with config #3's flags on the
      synthetic digits (8192 images, 1024 test) with the committed digits
      classifier models/svhn_classifier_weights_synth_digits_8192.msgpack
      copied into the run's models/: 40 steps, evals and checkpoints every
      20, --resume to 60, the probe and cluster columns in every test record
      and the classifier's test accuracy at least 0.9; then --model gmvae for
      20 steps; both with -viz;
  P10 P1 with --compute_dtype bfloat16 (every Dense and Conv in bfloat16, the
      parameters float32): the same seed and batches, the render and crop
      pairs on float32 inputs once a step;
  P11 P5 in bfloat16;
  P12 config #2 in bfloat16 through vae_main: 20 steps, one eval;
  P13 data parallelism: P1's configuration, seed and batches (config #5,
      global B=256) in 2 processes on the one card, 128 rows each, over gloo
      (NCCL refuses two ranks on one GPU): 3 train steps through the render
      and crop kernels, held against the same 3 steps in one process;
  P14 vae_main at config #2's flags through --coordinator, --num_processes
      and --process_id on NCCL: 2 processes on 2 cards where there are two,
      else a 1-process NCCL group on the one card, whose step does no
      collective, and then the flat all-reduce on the card;
  P15 tensor parallelism: P13's configuration, seed and batches in 4
      processes on the one card over gloo, a grid of 2 data x 2 model (128
      rows a data index), the 12 weights of the JAX rule sharded (31,670,272
      of 32,073,267 parameters), held against P13's references; then, where
      the machine has 2 cards, spair_main at config #5's flags with
      --num_model_shards 2 over NCCL for 20 steps (with one card, a line says
      that the CLI's tensor parallelism is held by the CPU tests);
  P16 chained steps, the card against the CPU: 5 train steps of a small
      LG-SPAIR through each render pair (and the crop pair) and of a small
      LGGMVae in float64, from a step just before a schedule's boundary (the
      z_pres anneal's end at 9,999; the GM learning rate's step at count
      1,000,000), and the full-canvas LG-SPAIR chain again from step 0 with a
      fresh Adam state (the bias correction and the anneals' starts), the
      draws replayed, held at tests/test_torch_trajectory.py's
      tolerances: each step's metrics at rtol 1e-4, the parameters and both
      Adam moments after the last step within 1e-4 of each tensor's L2 norm;
  P17 config #4 (SPLIT-GMVAE on CelebA 64x64) through vae_main with the
      README's flags (beta 120, alpha 40, y_size 30, patch 8, -no_label,
      -viz) and -synthetic_data: 40 steps with evals and checkpoints every 20,
      then --resume to step 60, with the GM encoder's spans
      (forward.gm_encoder, gm.y) on and their calls logged.

P6, P7, P9, P12 and P17 also check the PNG artifacts of every eval: the names
the JAX loop writes for the model and flags, each file decoded by
split_vae_torch/viz/png.py at its canvas's shape, no "[viz] ... skipped"
line; the count, the bytes and the viz ms an eval are logged.

Phases, each of which must pass:

  1. the card's name and power limit, from nvidia-smi;
  2. build the kernels from split_vae_torch/csrc (one nvcc a source, side by
     side, sm_90a), timed;
  3. each kernel against its plain PyTorch version on the card (TF32 off).
     Both render pairs take the paste's sample coordinates ys, xs: the
     full-canvas pair is held to render_taps_reference, the row-windowed pair
     to render_windowed_taps_reference, at the config-#5 shapes and at an
     unaligned shape (30-px objects on 45-px canvases), with render noise 0
     and 0.01, at 28-px objects on 48 px, at config #5 with z_where x10
     (saturated boxes, coordinates far outside the object) and with 1, 2 and
     4 colour channels (2 and 4 run the kernels' general instance); the six
     gradients (objs, ys, xs, z_pres, depth_w, bg); two runs of each kernel
     bit-equal. The windowed pair also against the full-canvas kernel on the
     same inputs and seed (forward atol 3e-6), with g_ys exactly zero outside
     the bands, and on a 66-row canvas (the kernels find a band in three
     32-row ballots). With --parent, the full-canvas pair at C = 1 and 3 also
     bit-equal to the kernel that checkout builds from its render.cu. Crop
     (over the sample coordinates ys, xs): at 48 -> 32 px and 48 -> 28 px
     (B=256), with 6 channels, at a ragged shape (9 cells, 45 -> 30 px) and
     at 48 -> 32 px with z_where x10; the gradients of img, ys and xs, and the
     two the model's path asks for; two runs of each kernel bit-equal.
     Forward atol 3e-5, gradients rtol 1e-3, atol 2e-4: the limits the JAX
     package's tests hold its Pallas kernels to (fp32 sums in another order);
  4. the kernels alone, which the benchmark does not time: kernel and plain
     times at the shapes of P1/P2/P4 and of P3 (median of CUDA-event timings
     on the device alone) and three-term bounds (bytes, of objs the sectors
     the taps read; FP32 operations; the Philox noise): the render with a
     sweep of its rows a block (forward) and cells a block (backward) and the
     render_noise kernel's time; the windowed pair in turns with the
     full-canvas pair, with the same sweep; the crop with two library times
     (the one-call einsum on prebuilt weights; interp_matrix twice and that
     einsum) and a sweep of its cells a block; the fused optimizer
     (kernels/adam.py, run_adam) at config #5's 74 leaves and config #2's
     40: two steps of the clipped and the unclipped chain bit for bit
     against the foreach chain, two of the clipped chain over max_norm
     within 16 ulp of it, and twice from one state bit-equal, the step's
     CUDA-event ms beside its bytes (44 a parameter at 3.35 TB/s), each
     pass's profiled ms, and the foreach chain's device ms and launches;
     the count prior's pair (kernels/count_prior.py, run_count_prior)
     against the loop of ATen ops on the card at the CPU tests' cases (B 1,
     7, 256; grids 1x1, 4x4, 6x6, 3x2; priors 1e-4, 0.5, 0.99 as numbers and
     device tensors; logits at +-10; exp overflowing on either side), rtol
     1e-5, atol 1e-6, NaN and inf where the loop has them, two runs bit-equal,
     then both sides' forward and forward + backward device ms at config #5's
     shapes as CUDA graphs replay them, their launches and the bound;
  5. one small train step on the card against the same step on the CPU (plain
     kernels' versions) for LG-SPAIR (full-canvas and windowed render),
     BG-SPAIR, LGGlimpseSPAIR, LGVae, LGGMVae and GMVae (the GM steps with
     their dropout masks live; their gradients held in float64 on both
     devices, since the Gumbel softmax's backward cancels below the float32
     tolerance), then P16's chained steps (above), then each main path:
     TRAIN_STEPS train steps (run_steps) with the kernels' launch counts set
     to 0 before and read after, every step after the first a CUDA graph
     replay (step.graphed, step.eager; LGGlimpseSPAIR's glimpse.scramble one
     a step), every loss finite, no update skipped, no
     call of interp_matrix (no dense interpolation weights), the fused
     optimizer's three launches a step, the count prior's pair once each
     way a step on the SPAIR paths and never on the VAE paths, the
     parameters and the optimizer's
     state float32 after the steps and the peak device memory; then one eval
     step; P4's losses beside P1's; P10 and P11 as P1 and P5, their first
     losses within rtol 0.02 of P1's and P5's; the resize2x -> conv fusion
     (nn/pixel_shuffle.py, resize_conv_sites): at every site of the main
     paths (RESIZE_CONV_SITES: P1's ObjDecoder at 4096 x 8 -> 16 -> 32, also
     by the dilated form; P3's ObjDecoder and GlimpseDecoder at 7 -> 14 ->
     28; the BackgroundModel of P2/P3 at 6 -> 12 -> 24 -> 48; P5's
     ConvDecoder.Conv_3, 32 -> 64, k 6) the fused form and its mixed form
     against the chain, float32 and bfloat16, the output and the three
     gradients (RESIZE_CONV_LIMITS; any miss fails); then P6 and P7, each in
     a temporary directory (working directory, data_dir, output_dir): the
     records at steps 20, 40 and, after the resume, 60 under train/ and each
     test prefix, all finite, no update skipped, "Resumed from ... at step
     40", at most 3 checkpoints and the final weights of each run; on P6 the
     launch counts (0 before, read after both runs: the render pair and the
     crop's backward once a train step) and no interp_matrix call with
     autograd on; the checkpoints' write times and sizes and the peak device
     memory; P12 as P7 without the resume; P8 as P5, with every launch count
     0; P9's and P17's checks above; P13: each process's draw from a CUDA
     generator of one seed bit-equal to this process's, the ranks' mean loss
     against the 1-process loss (rtol 1e-5 at the first step, 1e-4 after),
     the first step's reduced gradients against the mean of the two halves'
     gradients computed in this process (each tensor within 1e-5 of its L2
     norm; the 1-process gradient's gap logged beside it), the parameters
     after the first step within 1e-5 of the two halves' step computed in
     this process where |g| >= 1e-5 (Adam's rule; the 1-process run's gap
     logged), after the 3 steps bit-equal across the ranks and within 2 lr a
     step of both references, and each of the 3 steps alone against the two
     halves' step computed in this process from the ranks' own parameters
     and optimizer state before it (gradients within 1e-5 of a tensor's L2
     norm, parameters at Adam's rule: a fault at any step fails it; the
     emulation's own chain beside it, logged), each rank's launches (the
     render pair and the crop pair once a step) and its peak device memory;
     P15: each rank at its place in the grid, the JAX rule's 12 sharded
     weights, the ranks of a model index bit-equal and the replicated leaves
     bit-equal on every rank, the data indices' mean loss against the
     1-process one (rtol 1e-5 at the first step, 1e-4 after), the first
     gathered gradients within 1e-5 of a norm of the data halves' mean, the
     gathered parameters after the first step at Adam's rule of both
     references, after 3 within 2 lr a step of both, each step alone as
     P13's, each rank's launches (the render and crop pairs once a step) and
     its peak device memory, beside the card's name and power limit; P14:
     the records at step 20, the backend, on 2 cards one call of the
     gradients' all-reduce a step on each rank, on one card the flat
     all-reduce leaving its tensors as they were;
  6. one JSON line of the kernels (then the fused optimizer's row: its
     times at config #5's leaves, its launches on each main path that
     counts them, P1-P12 and P17 but the classifier's; the count prior's
     row last, with its launches on P1-P5, P8, P10, P11), then the card, then
     {"ok": true, ...}.

Exits non-zero, printing no result, without CUDA or without the repository
beside it.
"""

from __future__ import annotations

import argparse
import copy
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# Lane instructions of one csrc/philox.cuh::normal_at (Philox-4x32-10 and
# Box-Muller) on its fast path: 111 in the sm_90a SASS of render.cu's
# render_noise_kernel (cuobjdump -sass; from the first Philox multiply to the
# last multiply of the normal, without the cosf and sqrtf slow paths that
# arguments below 105615 and normal inputs never take, and without the
# kernel's own index, load and store code): 20 FFMA, 19 LOP3, 17 IMAD (14
# IMAD.WIDE), 8 FMUL, 1 MUFU.RSQ and the rest. Integer multiplies, conversions
# and MUFU issue at a fraction of the FP32 rate, so the bound below, one
# instruction a lane a clock, is a floor the card cannot reach.
NORMAL_INSTRUCTIONS = 111
FWD_ATOL = 3e-5
WINDOWED_VS_FULL_ATOL = 3e-6
GRAD_RTOL, GRAD_ATOL = 1e-3, 2e-4
TRAIN_STEPS = 8
SLEEP_CYCLES = 5_000_000  # about 3 ms at the H100's clocks: longer than any run's host time


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
    """Median device milliseconds of fn() over reps runs, each between two
    CUDA events. A sleep kernel (SLEEP_CYCLES) ahead of each run keeps the
    card busy while the host enqueues the run's launches, so the time is the
    device's alone and not the wrappers' host time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def by_name(torch, fn, steps=10):
    """Device ms a call of fn by kernel name (torch.profiler, after one call
    outside the profile), and the launches a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    names = {}
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        names[e.name] = names.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-3 / steps
    return names, len(kernels) / steps


def graph_ms(torch, fn, reps: int = 50):
    """Median device ms of one replay of a CUDA graph of fn (captured after
    three warm-up calls on a side stream), as a train step's graph runs it:
    each kernel with the gap the replay leaves before the next."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, reps=reps)
    del graph
    return ms


def render_inputs(torch, b, grid, os_, canvas, c, seed, z_scale=1.0):
    """Config-#5-like render inputs on the card from random boxes (z_where
    from N(0, 1) times z_scale: at 10 most boxes saturate and many
    coordinates fall outside the object). Returns the render pairs' six
    inputs (objs, ys, xs, z_pres, depth_w, bg: the paste's sample coordinates)
    and the seed tensor."""
    from split_vae_torch.ops.stn import paste_sample_coords

    g = torch.Generator(device="cuda").manual_seed(seed)
    k = grid * grid
    objs = torch.rand((b, k, os_, os_, c + 1), generator=g, device="cuda")
    z_where = z_scale * torch.randn((b, grid, grid, 4), generator=g, device="cuda")
    ys, xs, _ = paste_sample_coords(z_where, (canvas, canvas), (os_, os_))
    z_pres = torch.rand((b, k), generator=g, device="cuda")
    depth_w = torch.sigmoid(-torch.randn((b, k), generator=g, device="cuda")) + 0.5
    bg = torch.rand((b, canvas, canvas, c), generator=g, device="cuda")
    seed_t = torch.tensor([seed * 7919 + 1], dtype=torch.int32, device="cuda")
    return [objs, ys.contiguous(), xs.contiguous(), z_pres, depth_w, bg], seed_t


INPUT_NAMES = ("objs", "ys", "xs", "z_pres", "depth_w", "bg")


def hold_to_plain(torch, what, out_k, out_p, ins_k, ins_p, seed):
    """Fails unless a render kernel's forward (atol FWD_ATOL) and its six
    gradients under one random cotangent (GRAD_RTOL, GRAD_ATOL) agree with the
    plain version's; returns (fwd err, bwd err, the kernel's gradients)."""
    cot = torch.randn(out_k.shape, generator=torch.Generator(device="cuda").manual_seed(seed),
                      device="cuda")
    g_k = torch.autograd.grad(out_k, ins_k, cot)
    g_p = torch.autograd.grad(out_p, ins_p, cot)
    torch.cuda.synchronize()
    fwd_err = (out_k - out_p).abs().max().item()
    if not fwd_err <= FWD_ATOL:
        fail(f"{what}: forward max |kernel - plain| {fwd_err:.3g} > {FWD_ATOL}")
    bwd_err = 0.0
    for name, a, p in zip(INPUT_NAMES, g_k, g_p):
        err = (a - p).abs()
        excess = (err - (GRAD_ATOL + GRAD_RTOL * p.abs())).max().item()
        if not excess <= 0:
            fail(f"{what}: backward d{name} max err {err.max().item():.3g} "
                 f"beyond rtol {GRAD_RTOL}, atol {GRAD_ATOL}")
        bwd_err = max(bwd_err, err.max().item())
    return fwd_err, bwd_err, g_k


def compare_kernels(torch, render, shape, noise_scale, seed, z_scale=1.0, windowed=None):
    """Kernel pair vs its plain version: forward and the six gradients (objs,
    ys, xs, z_pres, depth_w, bg); then two runs of each kernel must give
    bit-equal outputs. The full-canvas pair (``render_taps_reference``), or
    with ``windowed`` the row-windowed pair (``render_windowed_taps_reference``),
    which is also held to the full-canvas kernel on the same inputs and seed
    (forward atol WINDOWED_VS_FULL_ATOL) and must give ys no gradient outside
    the bands. Returns (fwd err, bwd err)."""
    b, grid, os_, canvas, c = shape
    args, seed_t = render_inputs(torch, b, grid, os_, canvas, c, seed, z_scale)
    noise = None
    if noise_scale > 0:
        noise = noise_scale * render.render_noise(seed_t, b, grid * grid, c, canvas, canvas)
    ins_k = [a.clone().requires_grad_(True) for a in args]
    ins_p = [a.clone().requires_grad_(True) for a in args]
    if windowed is None:
        label, module = "render", render
        out_k = render.fused_paste_render(*ins_k, seed_t, noise_scale)
        out_p = render.render_taps_reference(*ins_p, noise)
    else:
        label, module = "windowed render", windowed
        out_k = windowed.fused_paste_render_windowed(*ins_k, seed_t, noise_scale)
        out_p = windowed.render_windowed_taps_reference(*ins_p, noise)
    what = f"{shape} noise {noise_scale}" + (f", z_where x{z_scale:g}" if z_scale != 1.0 else "")
    fwd_err, bwd_err, g_k = hold_to_plain(torch, f"{label} {what}", out_k, out_p, ins_k, ins_p,
                                          seed)
    g = torch.randn((b, canvas, canvas, c), generator=torch.Generator(device="cuda")
                    .manual_seed(seed), device="cuda")
    _, sums = module._fwd(*args, seed_t, noise_scale)
    calls = {"fwd": lambda: module._fwd(*args, seed_t, noise_scale),
             "bwd": lambda: module._bwd(*args, seed_t, noise_scale, sums, g)}
    for name, call in calls.items():
        if not all(torch.equal(x, y) for x, y in zip(call(), call())):
            fail(f"{label} {name} {what}: two runs of the kernel differ")
    ys, xs = args[1], args[2]
    if windowed is not None:
        full_err = (out_k - render.fused_paste_render(*args, seed_t, noise_scale)).abs().max()
        full_err = full_err.item()
        if not full_err <= WINDOWED_VS_FULL_ATOL:
            fail(f"windowed render {what}: max |windowed - full-canvas kernel| {full_err:.3g} > "
                 f"{WINDOWED_VS_FULL_ATOL}")
        bands = windowed.compute_bands(ys, os_)
        stray = int(torch.count_nonzero(g_k[1][~windowed.band_mask(bands, canvas)]).item())
        if stray:
            fail(f"windowed render {what}: {stray} non-zero entries of g_ys outside the bands")
        rows = bands[..., 1].float()
        log(f"  windowed {what}: forward max err {fwd_err:.3g}, gradients max err "
            f"{bwd_err:.3g}, repeats bit-equal, vs the full-canvas kernel {full_err:.3g}, g_ys "
            f"zero outside the bands (band rows: mean {rows.mean().item():.2f}, max "
            f"{int(rows.max().item())} of {canvas})")
        return fwd_err, bwd_err
    outside = [((u < 0) | (u >= os_ - 1)).float().mean().item() for u in (ys, xs)]
    biggest = max(ys.abs().max().item(), xs.abs().max().item())
    log(f"  {what}: forward max err {fwd_err:.3g}, gradients max err {bwd_err:.3g}, repeats "
        f"bit-equal; {outside[0]:.1%} of row and {outside[1]:.1%} of column coordinates "
        f"outside [0, {os_ - 1}), max |coordinate| {biggest:.3g}")
    return fwd_err, bwd_err


def compare_with_parent(torch, render, parent):
    """The full-canvas pair at C = 1 and 3 against the render library that
    another checkout (``--parent DIR``) builds with its own kernels/build.py
    from its own csrc/render.cu: the output, the sums and the six gradients
    must be bit-equal on the same inputs."""
    import ctypes

    proc = subprocess.run([sys.executable, "-c", "from split_vae_torch.kernels import build; "
                           "print(build.build('render'))"], cwd=parent, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        fail(f"building {parent}'s render library: {proc.stderr}")
    lib = ctypes.CDLL(proc.stdout.split()[-1])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.render_fwd.argtypes = [p] * 7 + [f, p, p] + [i] * 8 + [p]
    lib.render_bwd.argtypes = [p] * 7 + [f] + [p] * 8 + [i] * 8 + [p]
    lib.render_fwd.restype = lib.render_bwd.restype = i
    cases = (((256, 4, 32, 48, 3), 0.01, 1.0), ((8, 4, 30, 45, 3), 0.0, 1.0),
             ((256, 4, 32, 48, 3), 0.01, 10.0), ((8, 4, 30, 45, 1), 0.01, 1.0))
    for n, (shape, noise_scale, z_scale) in enumerate(cases):
        b, grid, os_, canvas, c = shape
        args, seed_t = render_inputs(torch, b, grid, os_, canvas, c, 40 + n, z_scale)
        g = torch.randn((b, canvas, canvas, c), device="cuda")
        out_, sums = render._fwd(*args, seed_t, noise_scale)
        ours = [out_, sums, *render._bwd(*args, seed_t, noise_scale, sums, g)]
        theirs = [torch.empty_like(t) for t in ours]
        ptrs = [t.data_ptr() for t in (*args, seed_t)]
        dims = (b, grid * grid, os_, os_, canvas, canvas, c)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.render_fwd(*ptrs, noise_scale, theirs[0].data_ptr(), theirs[1].data_ptr(),
                             *dims, render.ROWS_PER_BLOCK, stream)
        err = err or lib.render_bwd(*ptrs, noise_scale, theirs[1].data_ptr(), g.data_ptr(),
                                    *(t.data_ptr() for t in theirs[2:]), *dims,
                                    render.CELLS_PER_BLOCK, stream)
        if err:
            fail(f"{parent}'s render kernels: CUDA error {err}")
        if not all(torch.equal(x, y) for x, y in zip(ours, theirs)):
            fail(f"render {shape} noise {noise_scale} z_where x{z_scale:g}: outputs differ from "
                 f"the kernel of {parent}")
    log(f"  render at C = 1 and 3: output, sums and six gradients bit-equal to the kernel "
        f"built from {parent} ({len(cases)} cases)")


def object_sectors(torch, shape, ys, xs):
    """Bytes of objs [B,K,h,w,C+1] (fp32) that the render pairs must read, in
    32-byte sectors: the object pixels that some canvas pixel's four taps
    read, i.e. the rows of the in-object row taps times the columns of the
    in-object column taps, cell by cell. Cells whose box misses the object
    read nothing. The row-windowed pair reads the same: every row with an
    in-object tap lies in its band."""
    b, grid, h, _, c = shape
    w = h

    def used(u, n):  # [B,K,N] coordinates -> [B,K,n]: the indices an in-object tap reads
        x0 = torch.floor(u)
        i0, i1 = x0.clamp(0, n - 1).long(), (x0 + 1).clamp(0, n - 1).long()
        apart = i0 != i1
        out = torch.zeros(u.shape[:-1] + (n + 1,), dtype=torch.bool, device=u.device)
        out.scatter_(-1, torch.where(apart, i0, n), True)
        out.scatter_(-1, torch.where(apart, i1, n), True)
        return out[..., :n]

    read = used(ys, h)[..., :, None] & used(xs, w)[..., None, :]
    floats = read[..., None].expand(b, grid * grid, h, w, c + 1).reshape(-1)
    floats = torch.nn.functional.pad(floats, (0, -floats.numel() % 8))
    return 32 * int(floats.view(-1, 8).any(dim=1).sum().item())


def bounds(shape, ys, xs, noise_scale, rows=None):
    """Least times (ms) for the forward and backward kernels at this shape and
    on these coordinates: the largest of three terms. ``rows`` is the number
    of canvas rows the pair computes, summed over the B*K cells: all of them
    (B*K*H, the default) for the full-canvas pair, the bands' rows for the
    row-windowed one.

    Bytes: each input read once, each output written once (fp32), and of
    objs only the 32-byte sectors that this run's taps read
    (``object_sectors``). Forward: objs, ys, xs, z_pres, depth_w, bg in; out
    and the sums (C+2 planes) out. Backward: those inputs, the sums and g in;
    g_objs (in full), g_ys, g_xs, g_zp, g_wd, g_bg out.
    Operations, as the kernels do them and as this run's boxes need them
    (``in_box``: pixel-cells whose row and column taps both lie in the
    object): the paste 9 FLOP a channel (three products, three FMAs) in the
    box; the composite 7 + 6C a computed pixel-cell; backward also the
    coordinates' parts (10 a channel), the gather of g_obj (8 a channel) and
    12 + 8C a computed pixel-cell for the composite's gradient.
    Noise: C Philox normals a computed pixel-cell (each kernel draws each
    once, at noise_scale > 0), NORMAL_INSTRUCTIONS lane instructions each, at
    one instruction a lane a clock on 132 SMs x 128 lanes at 1.98 GHz
    (PEAK_FP32 / 2).
    Returns {"fwd"/"bwd": (ms, by, bytes, FLOP, term)} and the bytes of objs
    read: ``by`` is "bytes" or "operations" (the noise counts as operations),
    ``term`` names the largest of "bytes", "FP32 operations", "noise".
    """
    import torch

    b, grid, h, hh, c = shape
    k, c1, w, ww = grid * grid, c + 1, h, hh
    cells = b * k
    rows_in = ((ys >= 0) & (ys < h - 1)).sum(-1)
    cols_in = ((xs >= 0) & (xs < w - 1)).sum(-1)
    in_box = int((rows_in * cols_in).sum().item())
    px_cells = (cells * hh if rows is None else rows) * ww
    objs_read = object_sectors(torch, shape, ys, xs)
    rest = 4 * (cells * (hh + ww + 2) + b * hh * ww * c)  # ys, xs, z_pres, depth_w, bg
    grads = 4 * cells * h * w * c1 + rest  # the backward's outputs
    sums_g = 4 * b * hh * ww * (c + 2 + c)  # forward: out and sums; backward: sums and g
    fwd_ops = in_box * 9 * c1 + px_cells * (7 + 6 * c)
    bwd_ops = in_box * (9 + 10 + 8) * c1 + px_cells * (12 + 8 * c)
    normals = px_cells * c if noise_scale > 0 else 0
    t_noise = normals * NORMAL_INSTRUCTIONS / (PEAK_FP32 / 2) * 1e3
    out = {}
    for name, nbytes, flops in (("fwd", objs_read + rest + sums_g, fwd_ops),
                                ("bwd", objs_read + rest + grads + sums_g, bwd_ops)):
        terms = {"bytes": nbytes / PEAK_BYTES * 1e3, "FP32 operations": flops / PEAK_FP32 * 1e3,
                 "noise": t_noise}
        term = max(terms, key=terms.get)
        out[name] = (terms[term], "bytes" if term == "bytes" else "operations", nbytes, flops,
                     term)
    return out, objs_read


def windowed_bounds(shape, ys, xs, noise_scale, band_rows: int):
    """``bounds`` of the row-windowed pair: the full pair's bytes (the same
    sectors of objs), and the operations and the Philox noise of this run's
    band rows only (``band_rows``, the bands' lengths summed over the B*K
    cells)."""
    return bounds(shape, ys, xs, noise_scale, rows=band_rows)


def time_windowed(torch, render, windowed, shape, noise_scale):
    """Times of the windowed pair, its plain version and the full-canvas pair
    on the same inputs, in turns within one call (full, windowed, windowed,
    full); the windowed forward at each rows-a-block count of
    ROWS_PER_BLOCK_SWEEP and its backward at each cells-a-block count of
    RENDER_CELLS_PER_BLOCK_SWEEP. Also the inputs' coordinates and the sum of
    band rows, for the bounds."""
    b, grid, os_, canvas, c = shape
    args, seed_t = render_inputs(torch, b, grid, os_, canvas, c, 11)
    noise = noise_scale * render.render_noise(seed_t, b, grid * grid, c, canvas, canvas)
    g = torch.rand((b, canvas, canvas, c), device="cuda")
    ins = [a.clone().requires_grad_(True) for a in args]
    out_p = windowed.render_windowed_taps_reference(*ins, noise)
    _, sums = render._fwd(*args, seed_t, noise_scale)
    _, w_sums = windowed._fwd(*args, seed_t, noise_scale)
    calls = {
        "full_fwd": lambda: render._fwd(*args, seed_t, noise_scale),
        "fwd": lambda: windowed._fwd(*args, seed_t, noise_scale),
        "full_bwd": lambda: render._bwd(*args, seed_t, noise_scale, sums, g),
        "bwd": lambda: windowed._bwd(*args, seed_t, noise_scale, w_sums, g),
    }
    turns = {name: [] for name in calls}
    for order in (("full_fwd", "fwd", "full_bwd", "bwd"), ("fwd", "full_fwd", "bwd", "full_bwd")):
        for name in order:
            turns[name].append(cuda_ms(calls[name]))
    times = {name: statistics.mean(v) for name, v in turns.items()}
    times["turns"] = turns
    times["plain_fwd"] = cuda_ms(lambda: windowed.render_windowed_taps_reference(*args, noise))
    times["plain_bwd"] = cuda_ms(lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True))
    times["sweep_fwd"] = {n: cuda_ms(lambda: windowed._fwd(*args, seed_t, noise_scale,
                                                           rows_per_block=n))
                          for n in ROWS_PER_BLOCK_SWEEP}
    times["sweep_bwd"] = {n: cuda_ms(lambda: windowed._bwd(*args, seed_t, noise_scale, w_sums, g,
                                                           cells_per_block=n))
                          for n in RENDER_CELLS_PER_BLOCK_SWEEP}
    times["coords"] = (args[1], args[2])
    times["band_rows"] = int(windowed.compute_bands(args[1], os_)[..., 1].sum().item())
    return times


ROWS_PER_BLOCK_SWEEP = (1, 2, 4, 8, 10)
RENDER_CELLS_PER_BLOCK_SWEEP = (1, 2, 4, 8, 16)


def time_render(torch, render, shape, noise_scale):
    """Kernel and plain times (the plain version: ``render_taps_reference``
    and its autograd backward), the ``render_noise`` kernel writing the same
    call's normals (a yardstick for the noise term), the forward at each
    rows-a-block count of ROWS_PER_BLOCK_SWEEP and the backward at each
    cells-a-block count of RENDER_CELLS_PER_BLOCK_SWEEP. Also returns the
    inputs' coordinates, for the bounds."""
    b, grid, os_, canvas, c = shape
    args, seed_t = render_inputs(torch, b, grid, os_, canvas, c, 11)
    noise = noise_scale * render.render_noise(seed_t, b, grid * grid, c, canvas, canvas)
    g = torch.rand((b, canvas, canvas, c), device="cuda")
    ins = [a.clone().requires_grad_(True) for a in args]
    out_p = render.render_taps_reference(*ins, noise)
    _, sums = render._fwd(*args, seed_t, noise_scale)
    times = {
        "fwd": cuda_ms(lambda: render._fwd(*args, seed_t, noise_scale)),
        "bwd": cuda_ms(lambda: render._bwd(*args, seed_t, noise_scale, sums, g)),
        "plain_fwd": cuda_ms(lambda: render.render_taps_reference(*args, noise)),
        "plain_bwd": cuda_ms(lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True)),
        "noise": cuda_ms(lambda: render.render_noise(seed_t, b, grid * grid, c, canvas, canvas)),
        "coords": (args[1], args[2]),
    }
    times["sweep_fwd"] = {n: cuda_ms(lambda: render._fwd(*args, seed_t, noise_scale,
                                                         rows_per_block=n))
                          for n in ROWS_PER_BLOCK_SWEEP}
    times["sweep_bwd"] = {n: cuda_ms(lambda: render._bwd(*args, seed_t, noise_scale, sums, g,
                                                         cells_per_block=n))
                          for n in RENDER_CELLS_PER_BLOCK_SWEEP}
    return times


def crop_inputs(torch, b, grid, canvas, glimpse, c, seed, z_scale=1.0):
    """Crop inputs on the card: a random image, the sample coordinates of
    random boxes (z_where from N(0, 1) times z_scale: at 10 most boxes
    saturate and many coordinates fall outside the image), a cotangent."""
    from split_vae_torch.ops.stn import crop_sample_coords

    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((b, canvas, canvas, c), generator=g, device="cuda")
    z_where = z_scale * torch.randn((b, grid, grid, 4), generator=g, device="cuda")
    ys, xs, _ = crop_sample_coords(z_where, (canvas, canvas), (glimpse, glimpse))
    cot = torch.randn((b, grid * grid, glimpse, glimpse, c), generator=g, device="cuda")
    return img, ys.contiguous(), xs.contiguous(), cot


def compare_crop(torch, crop, shape, seed, z_scale=1.0):
    """Crop kernels vs the plain version over the same coordinates: forward,
    all three gradients, and the backward without g_img (the model's path);
    then two runs of each kernel call must give bit-equal outputs. Returns
    (fwd err, bwd err)."""
    img, ys, xs, cot = crop_inputs(torch, *shape, seed, z_scale)
    ins_k = [a.clone().requires_grad_(True) for a in (img, ys, xs)]
    ins_p = [a.clone().requires_grad_(True) for a in (img, ys, xs)]
    out_k = crop.stn_crop_taps(*ins_k)
    out_p = crop.crop_taps_reference(*ins_p)
    g_k = torch.autograd.grad(out_k, ins_k, cot)
    g_p = torch.autograd.grad(out_p, ins_p, cot)
    g_k2 = torch.autograd.grad(crop.stn_crop_taps(img, *ins_k[1:]), ins_k[1:], cot)
    torch.cuda.synchronize()
    what = f"{shape}" + (f", z_where x{z_scale:g}" if z_scale != 1.0 else "")
    fwd_err = (out_k - out_p).abs().max().item()
    if not fwd_err <= FWD_ATOL:
        fail(f"crop forward {what}: max |kernel - plain| {fwd_err:.3g} > {FWD_ATOL}")
    bwd_err = 0.0
    for name, a, p in zip(("img", "ys", "xs", "ys (no g_img)", "xs (no g_img)"),
                          g_k + g_k2, g_p + g_p[1:]):
        err = (a - p).abs()
        if not (err - (GRAD_ATOL + GRAD_RTOL * p.abs())).max().item() <= 0:
            fail(f"crop backward {what}: d{name} max err {err.max().item():.3g} "
                 f"beyond rtol {GRAD_RTOL}, atol {GRAD_ATOL}")
        bwd_err = max(bwd_err, err.max().item())
    calls = {"fwd": lambda: (crop._fwd(img, ys, xs),),
             "bwd": lambda: crop._bwd(img, ys, xs, cot, need_img=False)[1:],
             "bwd_all": lambda: crop._bwd(img, ys, xs, cot)}
    for name, call in calls.items():
        if not all(torch.equal(a, b) for a, b in zip(call(), call())):
            fail(f"crop {name} {what}: two runs of the kernel differ")
    outside = ((ys < 0) | (ys >= shape[2] - 1)).float().mean().item()
    log(f"  crop {what}: forward max err {fwd_err:.3g}, gradients max err {bwd_err:.3g}, "
        f"repeats bit-equal; {outside:.1%} of row coordinates outside [0, {shape[2] - 1})")
    return fwd_err, bwd_err


def crop_bounds(shape):
    """Least times (ms) for the crop's forward, its backward without g_img (as
    the model's path calls it) and its backward with all three gradients.

    Bytes: each input read once, each output written once (fp32): forward
    img, ys, xs in and the glimpses out; backward g, img, ys, xs in and g_ys,
    g_xs (and g_img) out. Operations, as the kernels do them: forward 9 FLOP
    an output (three multiplies, three FMAs); backward 8 FLOP an element of g
    (four FMAs) and 12 a pixel (four differences, the two weighted pairs, two
    sums), 8 more an element for g_img (four taps scattered); the sums over
    rows and columns not counted.
    """
    b, grid, hh, ho, c = shape
    cells, ww, wo = b * grid * grid, hh, ho
    img, coords, out = 4 * b * hh * ww * c, 4 * cells * (ho + wo), 4 * cells * ho * wo * c
    n_pix = cells * ho * wo
    fwd_ops, bwd_ops = 9 * n_pix * c, n_pix * (12 + 8 * c)
    res = {}
    for name, nbytes, flops in (("fwd", img + coords + out, fwd_ops),
                                ("bwd", out + img + 2 * coords, bwd_ops),
                                ("bwd_all", out + 2 * img + 2 * coords, bwd_ops + 8 * n_pix * c)):
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
        by = "bytes" if t_bytes > t_ops else "operations"
        res[name] = (max(t_bytes, t_ops), by, nbytes, flops, by)
    return res


CELLS_PER_BLOCK_SWEEP = (1, 2, 4, 8, 16)


def time_crop(torch, crop, shape):
    """Kernel, plain and two library times; "bwd" gives the gradients of ys
    and xs (the paths' call), "bwd_all" all three. Library: the one-call
    einsum on prebuilt weights and its autograd backward (to wy, wx; all
    three); chain: interp_matrix twice and that einsum, with its autograd
    backward to ys, xs (to all three), what the step ran before the kernels
    took coordinates. Also the kernels at each cells-a-block count of
    CELLS_PER_BLOCK_SWEEP."""
    img, ys, xs, cot = crop_inputs(torch, *shape, 13)
    h, w = shape[2], shape[2]

    def library(im, wy, wx):
        return torch.einsum("bkpi,bijc,bkqj->bkpqc", wy, im, wx)

    def chain(im, y, x):
        return library(im, crop.interp_matrix(y, h), crop.interp_matrix(x, w))

    wy, wx = crop.interp_matrix(ys, h), crop.interp_matrix(xs, w)
    lib_ins = [a.clone().requires_grad_(True) for a in (img, wy, wx)]
    out_lib = library(*lib_ins)
    chain_ins = [a.clone().requires_grad_(True) for a in (img, ys, xs)]
    out_chain = chain(*chain_ins)
    times = {
        "fwd": cuda_ms(lambda: crop._fwd(img, ys, xs)),
        "bwd": cuda_ms(lambda: crop._bwd(img, ys, xs, cot, need_img=False)),
        "bwd_all": cuda_ms(lambda: crop._bwd(img, ys, xs, cot)),
        "plain_fwd": cuda_ms(lambda: crop.crop_taps_reference(img, ys, xs)),
        "plain_bwd": cuda_ms(lambda: crop.crop_taps_backward_reference(img, ys, xs, cot, False)),
        "plain_bwd_all": cuda_ms(lambda: crop.crop_taps_backward_reference(img, ys, xs, cot)),
        "library_fwd": cuda_ms(lambda: library(img, wy, wx)),
        "library_bwd": cuda_ms(lambda: torch.autograd.grad(out_lib, lib_ins[1:], cot,
                                                           retain_graph=True)),
        "library_bwd_all": cuda_ms(lambda: torch.autograd.grad(out_lib, lib_ins, cot,
                                                               retain_graph=True)),
        "chain_fwd": cuda_ms(lambda: chain(img, ys, xs)),
        "chain_bwd": cuda_ms(lambda: torch.autograd.grad(out_chain, chain_ins[1:], cot,
                                                         retain_graph=True)),
        "chain_bwd_all": cuda_ms(lambda: torch.autograd.grad(out_chain, chain_ins, cot,
                                                             retain_graph=True)),
    }
    times["sweep"] = {
        n: (cuda_ms(lambda: crop._fwd(img, ys, xs, cells_per_block=n)),
            cuda_ms(lambda: crop._bwd(img, ys, xs, cot, need_img=False, cells_per_block=n)))
        for n in CELLS_PER_BLOCK_SWEEP}
    return times


ADAM_PASSES = (("reduce", 4), ("check", 12), ("commit", 28))  # bytes a parameter (csrc/adam.cu)


def adam_shapes(which: str):
    """The leaves of config #5's model ("c5", 74) or config #2's ("c2", 40)."""
    from split_vae_torch.core.config import CONFIG2_IMAGE_HW, config2, config5
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.loop import build_vae_model

    model = (get_spair_model(config5(), device="cpu") if which == "c5"
             else build_vae_model(config2(), CONFIG2_IMAGE_HW, device="cpu")[0])
    return [tuple(p.shape) for p in model.parameters()]


# The clipped chain over max_norm against the foreach chain: the kernels sum a
# leaf's norm in another order than _foreach_norm, so a clipped leaf's scale
# parts by a few ulp (tests/test_torch_fused_optim.py::CLIPPED_ULPS).
ADAM_CLIPPED_ULPS = 16


def run_adam(torch, np):
    """The fused optimizer (kernels/adam.py) at config #5's and config #2's
    leaves: two steps of the clipped chain (every norm under max_norm) and
    of the unclipped one against the foreach chain, bit for bit; two of the
    clipped chain over max_norm against it within ADAM_CLIPPED_ULPS (each
    element of a fixed sign, so that nothing cancels) and twice from one
    state, bit-equal; then the step's device time (CUDA events, a sleep
    ahead), each pass's (the profiler) beside its bytes at 3.35 TB/s, and
    the foreach chain's device time and launches. Returns the kernels line's
    row, with config #5's times and both sets' largest gap over max_norm."""
    from split_vae_torch.core import tracing
    from split_vae_torch.core.state import tree_tensors
    from split_vae_torch.train import optim

    def fresh(shapes, seed, scale, signs=None):
        """N(0, scale^2) tensors (of ``signs``' sign where given); 4-D ones
        channels-last, as cuDNN gives a convolution's weight gradient (the
        parameters take them contiguous)."""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        out = [scale * torch.randn(s, generator=gen, device="cuda") for s in shapes]
        if signs is not None:
            out = [sign * t.abs() for sign, t in zip(signs, out)]
        return [t.contiguous(memory_format=torch.channels_last if t.dim() == 4
                             else torch.contiguous_format) for t in out]

    def ulps(a, b):
        big = torch.maximum(a.abs(), b.abs())
        ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
        return float(((a - b).abs() / ulp).max())

    row, gaps = None, {}
    for label, shapes in (("c5", adam_shapes("c5")), ("c2", adam_shapes("c2"))):
        n = sum(int(np.prod(s)) for s in shapes)
        gen = torch.Generator(device="cuda").manual_seed(9)
        signs = [(torch.randint(0, 2, s, generator=gen, device="cuda") * 2 - 1).float()
                 for s in shapes]
        for chain, tx, scale in (("clipped", optim.spair_optimizer(1e-4), 1e-4),
                                 ("unclipped", optim.vae_optimizer(1e-4), 1e-4),
                                 ("clipped over max_norm", optim.spair_optimizer(1e-4), 1.0)):
            over = scale == 1.0
            params = [p.contiguous() for p in fresh(shapes, 1, 0.1, signs if over else None)]
            if over:  # p of the update's sign: p + u does not cancel
                params = [-p for p in params]
            ref = [p.clone() for p in params]
            state, ref_state = tx.init(params), tx.init(ref)
            before = tracing.counters().get("optim.fused", 0)
            with torch.no_grad():
                for i in range(2):
                    grads = fresh(shapes, 2 + i, scale, signs if over else None)
                    if optim.apply_updates(tx, params, grads, state) is not state:
                        fail(f"adam {label} {chain}: the step did not take the fused kernels")
                    updates, ref_state = tx.update(grads, ref_state)
                    torch._foreach_add_(ref, updates)
            launched = tracing.counters().get("optim.fused", 0) - before
            if over:
                clipped = sum(float(torch.linalg.vector_norm(g)) > 1.0 for g in grads)
                pairs = list(zip(params + tree_tensors(state), ref + tree_tensors(ref_state)))
                worst = max(ulps(a, b) for a, b in pairs if a.is_floating_point())
                gap = max(float((a.double() - b.double()).abs().max())
                          for a, b in pairs if a.is_floating_point())
                gaps[label] = (worst, gap)
                if worst > ADAM_CLIPPED_ULPS or clipped == 0 or not all(
                        torch.equal(a, b) for a, b in pairs if not a.is_floating_point()):
                    fail(f"adam {label} {chain}: {worst:.1f} ulp from the foreach chain (at most "
                         f"{ADAM_CLIPPED_ULPS}), {clipped} leaves clipped")
                detail = f"within {worst:.1f} ulp (max abs {gap:.3g}) of the foreach chain, " \
                         f"{clipped} of {len(shapes)} leaves clipped"
            else:
                for a, b in zip(params + tree_tensors(state), ref + tree_tensors(ref_state)):
                    if not torch.equal(a, b):
                        fail(f"adam {label} {chain}: the fused step is not the foreach chain's "
                             f"(max gap {(a.double() - b.double()).abs().max().item():.3g})")
                detail = "bit-equal to the foreach chain"
            if launched != 6:  # three a step: the leaves fit one launch a pass
                fail(f"adam {label} {chain}: {launched} launches in 2 steps")
            log(f"  adam {label} ({len(shapes)} leaves, {n} params), {chain}: 2 steps {detail}, "
                f"{launched} launches")
        tx = optim.spair_optimizer(1e-4)
        runs = []
        for _ in range(2):
            params = [p.contiguous() for p in fresh(shapes, 1, 0.1)]
            state = tx.init(params)
            with torch.no_grad():
                for i in range(2):
                    optim.apply_updates(tx, params, fresh(shapes, 2 + i, 1.0), state)
            runs.append(params + tree_tensors(state))
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"adam {label}: two runs of the clipped chain over max_norm differ")
        del runs

        params = [p.contiguous() for p in fresh(shapes, 1, 0.1)]
        state = tx.init(params)
        grads = fresh(shapes, 2, 1e-4)
        with torch.no_grad():
            ms = cuda_ms(lambda: optim.apply_updates(tx, params, grads, state))
            names, launches = by_name(torch,
                                      lambda: optim.apply_updates(tx, params, grads, state))
            ref_params = [p.contiguous() for p in fresh(shapes, 1, 0.1)]
            ref_state = [tx.init(ref_params)]

            def foreach():
                updates, ref_state[0] = tx.update(grads, ref_state[0])
                torch._foreach_add_(ref_params, updates)

            plain, plain_launches = by_name(torch, foreach)
        if int(state.total_notfinite) != 0:
            fail(f"adam {label}: a timed step was skipped")
        bound = 44 * n / PEAK_BYTES * 1e3
        pass_ms = {name: sum(v for k, v in names.items() if f"adam_{name}_kernel" in k)
                   for name, _ in ADAM_PASSES}
        plain_ms = sum(plain.values())
        log(f"adam at {label} ({len(shapes)} leaves, {n} params, clipped chain): kernels "
            f"{ms:.4f} ms a step ({bound / ms:.3f} of the bound {bound:.4f} ms, 44 B a "
            f"parameter at 3.35 TB/s), {launches:.0f} launches; "
            + ", ".join(f"{name} {pass_ms[name]:.4f} ms (bound {per * n / PEAK_BYTES * 1e3:.4f}, "
                        f"{per} B a parameter)" for name, per in ADAM_PASSES)
            + f"; the foreach chain {plain_ms:.4f} device ms in {plain_launches:.0f} launches")
        if row is None:
            row = {"name": "adam", "route": "cuda", "source": "split_vae_torch/csrc/adam.cu",
                   "replaces": "none: the JAX package leaves its optax chain to XLA",
                   "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
                   "pass_ms": pass_ms}
        del params, state, grads, ref_params, ref_state
        torch.cuda.empty_cache()
    row.update(max_abs_err=max(g for _, g in gaps.values()),
               max_ulps_over_max_norm={k: u for k, (u, _) in gaps.items()})
    return row


# The count prior's cases on the card (tests/test_torch_count_prior.py's, and
# config #5's shapes first): (B, grid, prior, prior as a device tensor, extreme).
COUNT_PRIOR_CASES = (
    [(256, (4, 4), 0.5, True, None)]
    + [(b, grid, prior, tensor, None) for b in (1, 7, 256) for grid in ((1, 1), (4, 4), (6, 6),
                                                                         (3, 2))
       for prior in (1e-4, 0.5, 0.99) for tensor in (False, True)]
    + [(7, (4, 4), 0.5, False, extreme) for extreme in ("logits_at_10", "posterior_exp_overflows",
                                                        "prior_exp_overflows")])
COUNT_PRIOR_RTOL, COUNT_PRIOR_ATOL = 1e-5, 1e-6  # the CPU tests' limits


def count_prior_inputs(torch, b, grid, seed, extreme=None, tau=0.8):
    """pres, logits, pre [B, gh, gw, 1] on the card: logits uniform in
    (-10, 10), pre a Binary-Concrete sample of them; ``extreme`` as in the
    CPU tests (logits at +-10 exactly, or exp(-pre tau + logits) past
    float32's range on the posterior's or the prior's side)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, *grid, 1)
    logits = torch.rand(shape, generator=gen, device="cuda") * 20 - 10
    u = torch.rand(shape, generator=gen, device="cuda") * 0.98 + 0.01
    pre = (logits + torch.log(u) - torch.log(1 - u)) / tau
    if extreme == "logits_at_10":
        logits = torch.where(torch.arange(logits.numel(), device="cuda").reshape(shape) % 2 == 1,
                             10.0, -10.0)
    elif extreme is not None:
        posterior = extreme == "posterior_exp_overflows"
        logits[:, 1:] = 60.0 if posterior else -50.0
        pre[:, 1:] = -60.0 if posterior else -120.0
    return torch.sigmoid(pre), logits, pre


def run_count_prior(torch, np):
    """The count prior's kernel pair (kernels/count_prior.py) against the loop
    of ATen ops (ops/count_prior.py::count_kl_loop), both on the card (CUDA
    inputs of another dtype than float32 must raise, not fall back): the
    value and the gradients of the logits and of pre at the CPU tests' cases
    (limits rtol 1e-5, atol 1e-6; NaN and inf where the loop has them), two
    runs bit-equal; then at config #5's shapes the device ms of each side's
    forward and forward + backward as CUDA graphs replay them, the launches a
    call, and the bound. Returns the kernels line's row."""
    from split_vae_torch.core import tracing
    from split_vae_torch.core.config import config5
    from split_vae_torch.ops.count_prior import count_kl_loop, z_pres_count_kl

    def value_and_grads(fn, pres, logits, pre, prior, tau):
        lo, pr = logits.clone().requires_grad_(True), pre.clone().requires_grad_(True)
        value = fn(pres, lo, pr, prior, tau)
        return [value.detach()] + list(torch.autograd.grad(value, (lo, pr)))

    def gap(a, b):
        """Largest |a - b| over max |b| among the finite entries; inf where
        the non-finite entries differ."""
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or not torch.equal(
                a[~torch.isfinite(a)].nan_to_num(), b[~torch.isfinite(b)].nan_to_num()):
            return float("inf")
        keep = torch.isfinite(b)
        if not keep.any():
            return 0.0
        return float((a[keep] - b[keep]).abs().max() / b[keep].abs().max().clamp_min(1e-30))

    tau = config5().tau
    # The card takes the kernels whatever the dtype: another than float32 raises, never the loop.
    for dtype in (torch.float64, torch.bfloat16):
        wrong = [t.to(dtype) for t in count_prior_inputs(torch, 4, (4, 4), 99, tau=tau)]
        before = tracing.counters()
        try:
            z_pres_count_kl(*wrong, 0.5, tau)
        except ValueError:
            pass
        else:
            fail(f"count prior: CUDA {dtype} inputs did not raise")
        if tracing.counters() != before:
            fail(f"count prior: CUDA {dtype} inputs launched a kernel")
    worst = [0.0, 0.0, 0.0]
    for i, (b, grid, prior_prob, as_tensor, extreme) in enumerate(COUNT_PRIOR_CASES):
        pres, logits, pre = count_prior_inputs(torch, b, grid, 100 + i, extreme, tau)
        prior = (torch.tensor(prior_prob, dtype=torch.float32, device="cuda") if as_tensor
                 else prior_prob)
        before = tracing.counters()
        kernel = value_and_grads(z_pres_count_kl, pres, logits, pre, prior, tau)
        after = tracing.counters()
        launched = {k: after.get(k, 0) - before.get(k, 0)
                    for k in ("count_prior.fwd", "count_prior.bwd")}
        if launched != {"count_prior.fwd": 1, "count_prior.bwd": 1}:
            fail(f"count prior B={b} grid {grid}: launches {launched}, not one each way")
        again = value_and_grads(z_pres_count_kl, pres, logits, pre, prior, tau)
        if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(kernel, again)):  # bit for bit, NaN included
            fail(f"count prior B={b} grid {grid} prior {prior_prob}: two runs differ")
        loop = value_and_grads(count_kl_loop, pres, logits, pre, prior, tau)
        for j, (what, x, y) in enumerate(zip(("value", "g_logits", "g_pre"), kernel, loop)):
            finite = torch.isfinite(y)
            held = torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(
                x[torch.isinf(y)], y[torch.isinf(y)]) and torch.allclose(
                x[finite], y[finite], rtol=COUNT_PRIOR_RTOL, atol=COUNT_PRIOR_ATOL)
            if not held:
                fail(f"count prior B={b} grid {grid} prior {prior_prob} ({extreme}): {what} of "
                     f"the kernels is not the loop's (relative gap {gap(x, y):.3g})")
            worst[j] = max(worst[j], gap(x, y))
        if i == 0 or extreme is not None:
            log(f"  count prior B={b} grid {grid} prior {prior_prob}"
                f"{' (device tensor)' if as_tensor else ''}{f' {extreme}' if extreme else ''}: "
                f"value {kernel[0].item():.6g} (loop {loop[0].item():.6g}); relative gaps "
                + ", ".join(f"{w} {gap(x, y):.3g}" for w, x, y in
                            zip(("value", "g_logits", "g_pre"), kernel, loop)))
    log(f"count prior: the kernels against the loop at {len(COUNT_PRIOR_CASES)} cases, two runs "
        f"bit-equal; largest relative gaps: value {worst[0]:.3g}, g_logits {worst[1]:.3g}, "
        f"g_pre {worst[2]:.3g}")

    # Times at config #5's shapes, the prior a device tensor as the train step hands it.
    b, grid = 256, (4, 4)
    pres, logits, pre = count_prior_inputs(torch, b, grid, 7, tau=tau)
    lo, pr = logits.clone().requires_grad_(True), pre.clone().requires_grad_(True)
    prior = torch.tensor(0.5, dtype=torch.float32, device="cuda")
    times, launches = {}, {}
    for side, fn in (("kernels", z_pres_count_kl), ("loop", count_kl_loop)):
        def forward(fn=fn):
            return fn(pres, lo, pr, prior, tau)

        def both(fn=fn):
            return torch.autograd.grad(fn(pres, lo, pr, prior, tau), (lo, pr))

        times[side] = (graph_ms(torch, forward), graph_ms(torch, both))
        launches[side] = (by_name(torch, forward)[1], by_name(torch, both)[1])
    one = torch.zeros(1, device="cuda")
    floor = graph_ms(torch, lambda: one.fill_(0.0))
    k = grid[0] * grid[1]
    fwd_bytes, bwd_bytes = 4 * (3 * b * k + b + b * k), 4 * (3 * b * k + b + 2 * b * k)
    bytes_ms = (fwd_bytes + bwd_bytes) / PEAK_BYTES * 1e3
    for side, (fwd, total) in times.items():
        log(f"count prior at B={b}, K={k} ({side}): forward {fwd:.4f} ms in "
            f"{launches[side][0]:.0f} launches, forward + backward {total:.4f} ms in "
            f"{launches[side][1]:.0f} launches (backward {total - fwd:.4f} ms); graph replays")
    log(f"count prior bound: bytes {(fwd_bytes + bwd_bytes) / 1e3:.1f} KB = "
        f"{bytes_ms * 1e3:.3f} us; a one-element fill in a graph {floor:.4f} ms (two launches: "
        f"{2 * floor:.4f} ms)")
    ms, plain_ms = times["kernels"][1], times["loop"][1]
    return {"name": "count_prior", "route": "cuda",
            "source": "split_vae_torch/csrc/count_prior.cu",
            "replaces": "none: the JAX package's lax.scan (split_vae_tpu/ops/count_prior.py)",
            "ms": ms, "kernel_ms": ms, "fwd_ms": times["kernels"][0],
            "bwd_ms": ms - times["kernels"][0], "plain_ms": plain_ms,
            "plain_fwd_ms": times["loop"][0], "plain_bwd_ms": plain_ms - times["loop"][0],
            "launches_a_call": launches["kernels"][1],
            "plain_launches_a_call": launches["loop"][1],
            "bound_ms": max(bytes_ms, 2 * floor), "bound_by": "launch floor"
            if 2 * floor > bytes_ms else "bytes", "library_ms": None,
            "max_rel_gap": max(worst)}


class RecordingNoise:
    """Draws like core.noise.Noise (one rank) and keeps each draw, for a replay."""

    def __init__(self, noise):
        self.noise, self.drawn = noise, []

    def normal(self, shape, dtype=None, per_example=None):
        self.drawn.append(self.noise.normal(shape, dtype))
        return self.drawn[-1]

    def uniform(self, shape, dtype=None, per_example=None):
        self.drawn.append(self.noise.uniform(shape, dtype))
        return self.drawn[-1]

    def normal_like(self, t, per_example=None):
        return self.normal(t.shape, t.dtype)

    def uniform_like(self, t, per_example=None):
        return self.uniform(t.shape, t.dtype)

    def batch_permutation(self, n, batch):
        import torch

        from split_vae_torch.core.noise import Noise

        u = self.uniform((batch, n), torch.float64)
        return Noise(self.noise.generator, [u]).batch_permutation(n, batch)

    def keep(self, shape, rate, per_example=None):
        self.drawn.append(self.noise.keep(shape, rate))
        return self.drawn[-1]

    def image_seed(self, batch):
        return self.noise.image_seed(batch)


def hold_small_step(torch, label, what, names, grads, results):
    """Card against CPU for one small train step: ``grads`` are the two lists
    of (clipped) gradients, ``results`` the two (metrics, params after Adam).

    Held: the gradients tensor by tensor (rtol 1e-3, atol 1e-6 max|g|), the
    step's metrics (rtol 1e-4), and the parameters after Adam (atol 1e-5)
    wherever the gradient is at least 1e-5. Below that, Adam's first step
    -lr g / (|g| + 1e-7) turns the summation-order differences of a near-zero
    gradient (the card's convolutions add in another order than the CPU's, and
    not the same order from run to run) into update differences of up to lr,
    so there only the gradient is held.
    """
    worst_g = 0.0
    for name, gc, gg in zip(names, *grads):
        excess = ((gg - gc).abs() - (1e-3 * gc.abs() + 1e-6 * gc.abs().max())).max().item()
        if not excess <= 0:
            fail(f"small step {label}: gradient of {name} differs by "
                 f"{(gg - gc).abs().max().item():.3g} (max |g| {gc.abs().max().item():.3g})")
        worst_g = max(worst_g, ((gg - gc).abs().max() / gc.abs().max()).item())
    (m_cpu, p_cpu), (m_gpu, p_gpu) = results
    for k in m_cpu:
        if not abs(m_gpu[k] - m_cpu[k]) <= 1e-4 * abs(m_cpu[k]) + 1e-6:
            fail(f"small step {label}: metric {k} card {m_gpu[k]} vs CPU {m_cpu[k]}")
    worst = 0.0
    for name, pc, pg, gc in zip(names, p_cpu, p_gpu, grads[0]):
        diff = torch.where(gc.abs() >= 1e-5, (pg - pc).abs(), torch.zeros_like(pc))
        worst = max(worst, diff.max().item())
        if not worst <= 1e-5:
            fail(f"small step {label}: {name} after Adam differs by {worst:.3g} > 1e-5")
    log(f"  small step {label} ({what}): gradients within {worst_g:.3g} max|g|, metrics "
        f"within rtol 1e-4 of the CPU step, params after Adam within {worst:.3g}")


def small_step_check(torch, np, cfg, label, windowed=False):
    """One small SPAIR-family train step on the card (kernels) against the CPU
    (plain versions), the same draws replayed; see ``hold_small_step``."""
    from split_vae_torch.core.noise import Noise
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.losses import spair_loss
    from split_vae_torch.train.optim import clip_by_per_tensor_norm, spair_optimizer
    from split_vae_torch.train.steps import make_spair_train_step, model_inputs

    hw = cfg.image_size[0]
    x = torch.from_numpy(np.random.RandomState(1).uniform(0, 1, (cfg.batch_size, hw, hw, 3))
                         .astype(np.float32))
    cpu = get_spair_model(cfg, device="cpu")
    gpu = get_spair_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    for m in (cpu, gpu):
        m.render_noise_scale = 0.0
    rec = RecordingNoise(Noise(torch.Generator().manual_seed(2)))
    with torch.no_grad():
        cpu(model_inputs(cfg, x, rec), True, rec)
    replay = rec.drawn  # the scramble's uniforms first where there are any

    grads = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        noise = Noise(torch.Generator(device=dev), replay)
        images = model_inputs(cfg, x.to(dev), noise)
        out = model(images, True, noise, windowed=windowed)
        total, _ = spair_loss(out, images, cfg, 0, training=True)
        g = torch.autograd.grad(total, list(model.parameters()))
        grads.append([t.cpu() for t in clip_by_per_tensor_norm(1.0).update(list(g), ())[0]])
    results = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        state = create_train_state(model, spair_optimizer(cfg.learning_rate), seed=0)
        state, metrics = make_spair_train_step(cfg, windowed_render=windowed)(
            state, x.to(dev), replay)
        results.append(({k: float(v) for k, v in metrics.items()},
                        [p.detach().cpu() for p in model.parameters()]))
    hold_small_step(torch, label, f"B={cfg.batch_size}, {hw} px, {cfg.object_size}-px objects",
                    [n for n, _ in cpu.named_parameters()], grads, results)


def small_vae_step_check(torch, np, cfg, hw, label, grad_dtype=None):
    """One small VAE-family train step on the card against the CPU, the same
    draws replayed (the GM models' dropout masks among them); see
    ``hold_small_step``. ``grad_dtype`` float64 takes the gradients in float64
    on both devices; the step's metrics and parameters stay float32."""
    from split_vae_torch.core.noise import Noise
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.train.loop import build_vae_model
    from split_vae_torch.train.steps import (
        augment,
        make_vae_train_step,
        normalize_images,
        vae_loss_fn,
    )

    grad_dtype = grad_dtype or torch.float32
    loss_of = vae_loss_fn(cfg)
    batch = torch.from_numpy(np.random.RandomState(1).randint(0, 255, (cfg.batch_size, *hw, 3))
                             .astype(np.uint8))
    cpu, tx = build_vae_model(cfg, hw, device="cpu")
    gpu, _ = build_vae_model(cfg, hw, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rec = RecordingNoise(Noise(torch.Generator().manual_seed(2)))
    with torch.no_grad():
        cpu(augment(cfg, normalize_images(batch, "tanh"), rec), True, rec)
    replay = rec.drawn

    grads = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        images = augment(cfg, normalize_images(batch.to(dev), "tanh"),
                         Noise(torch.Generator(device=dev), replay[:1]))
        wide = copy.deepcopy(model).to(grad_dtype)
        total, _ = loss_of(wide(images.to(grad_dtype), True,
                                Noise(torch.Generator(device=dev), replay[1:], dtype=grad_dtype)),
                           images.to(grad_dtype))
        grads.append([t.cpu() for t in torch.autograd.grad(total, list(wide.parameters()))])
    results = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        state = create_train_state(model, tx, seed=0)
        state, metrics = make_vae_train_step(cfg)(state, batch.to(dev), replay)
        results.append(({k: float(v) for k, v in metrics.items()},
                        [p.detach().cpu() for p in model.parameters()]))
    hold_small_step(torch, label, f"B={cfg.batch_size}, {hw[0]} px, patch {cfg.patch_size}, "
                    f"gradients in {str(grad_dtype).split('.')[-1]}",
                    [n for n, _ in cpu.named_parameters()], grads, results)


# P16: chained steps on the card against the same steps on the CPU.
CHAIN_STEPS = 5
# Just before a schedule's boundary, in the loop's step and in Adam's count
# (tests/test_torch_trajectory.py starts there too): the z_pres and zoom
# priors reach their ends at step 9,999; the GM learning rate steps at count
# 1,000,000.
SPAIR_CHAIN_START, GM_CHAIN_START = 9_995, 999_996
CHAIN_RTOL, CHAIN_NORM_TOL = 1e-4, 1e-4


def run_chain(torch, model, tx, train_step, batches, replays, start, device):
    """``train_step`` chained over ``batches`` on ``device`` from step and count
    ``start`` (Adam's moments at zero); each step's metrics, then the
    parameters and the moments after the last step, on the CPU."""
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.train.chains import adam_moments, at_count

    state = create_train_state(model, tx, seed=0)
    state.step = start
    state.opt_state = at_count(state.opt_state, start, torch.full_like)
    metrics = []
    for batch, replay in zip(batches, replays):
        state, m = train_step(state, batch.to(device), replay)
        metrics.append({k: float(v) for k, v in m.items()})
    mu, nu = adam_moments(state.opt_state)
    cpu = lambda ts: [t.detach().cpu() for t in ts]  # noqa: E731
    return metrics, {"params": cpu(model.parameters()), "mu": cpu(mu), "nu": cpu(nu)}


def hold_chain(label, what, names, cpu, card):
    """P16's check (tests/test_torch_trajectory.py's tolerances): every step's
    metrics at rtol 1e-4; after the last step each parameter and both Adam
    moments of each within 1e-4 of the CPU tensor's L2 norm."""
    from split_vae_torch.train.chains import metric_gap, tensor_gap

    (m_cpu, t_cpu), (m_card, t_card) = cpu, card
    worst_m = metric_gap(m_cpu, m_card)
    if not worst_m[0] <= CHAIN_RTOL:
        fail(f"P16 {label}: metric gap {worst_m[0]:.3g} at {worst_m[1]} > {CHAIN_RTOL}")
    gaps = {}
    for kind in ("params", "mu", "nu"):
        worst = tensor_gap(dict(zip(names, t_cpu[kind])), dict(zip(names, t_card[kind])))
        if not worst[0] <= CHAIN_NORM_TOL:
            fail(f"P16 {label}: {kind} of {worst[1]} {worst[0]:.3g} of its norm away from the "
                 f"CPU's after {CHAIN_STEPS} steps > {CHAIN_NORM_TOL}")
        gaps[kind] = worst
    log(f"  P16 {label} ({what}, {CHAIN_STEPS} chained steps): metrics within {worst_m[0]:.3g} "
        f"relative of the CPU's ({worst_m[1]}); after the last step " + ", ".join(
            f"{k} within {g:.3g} of a norm ({n})" for k, (g, n) in gaps.items()))


def chained_spair_check(torch, np, cfg, label, windowed=False, device="cuda",
                        start=SPAIR_CHAIN_START):
    """P16 for a SPAIR-family model: CHAIN_STEPS train steps on the card
    (through the render and crop kernels) against the same steps on the CPU
    (their plain versions), from step and Adam count ``start`` (0: a fresh
    state, as a run starts), on the same uint8 batches, the draws recorded on
    the CPU and replayed on both, render noise 0."""
    from split_vae_torch.core import tracing
    from split_vae_torch.core.noise import Noise
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.optim import spair_optimizer
    from split_vae_torch.train.steps import make_spair_train_step, model_inputs, normalize_images

    hw = cfg.image_size[0]
    rng = np.random.RandomState(3)
    batches = [torch.from_numpy(rng.randint(0, 256, (cfg.batch_size, hw, hw, 3)).astype(np.uint8))
               for _ in range(CHAIN_STEPS)]
    cpu = get_spair_model(cfg, device="cpu")
    card = get_spair_model(cfg, device=device)
    card.load_state_dict(cpu.state_dict())
    replays = []
    for i, batch in enumerate(batches):
        rec = RecordingNoise(Noise(torch.Generator().manual_seed(20 + i)))
        with torch.no_grad():
            cpu(model_inputs(cfg, normalize_images(batch, "unit"), rec), True, rec)
        replays.append(rec.drawn)
    pair = "render_windowed" if windowed else "render"
    counted = (f"{pair}.fwd", f"{pair}.bwd", "crop.bwd")
    runs = []
    for model, dev in ((cpu, "cpu"), (card, device)):
        model.render_noise_scale = 0.0
        before = tracing.counters()
        runs.append(run_chain(torch, model, spair_optimizer(cfg.learning_rate),
                              make_spair_train_step(cfg, windowed_render=windowed), batches,
                              replays, start, dev))
        after = tracing.counters()
        moved = [after.get(c, 0) - before.get(c, 0) for c in counted]
        if moved != ([CHAIN_STEPS] * 3 if dev != "cpu" else [0] * 3):
            fail(f"P16 {label}: the chain on {dev} launched the render pair and the crop's "
                 f"backward {moved} times")
    hold_chain(label, f"B={cfg.batch_size}, {hw} px, {cfg.object_size}-px objects, from "
               f"step {start}", [n for n, _ in cpu.named_parameters()], *runs)


def chained_gm_check(torch, np, cfg, hw, label, device="cuda"):
    """P16 for LGGMVae: CHAIN_STEPS float64 train steps on the card against
    the same on the CPU, from GM_CHAIN_START (the learning rate steps inside
    the chain), the draws and dropout masks recorded on the CPU and replayed."""
    from split_vae_torch.core.noise import Noise
    from split_vae_torch.train.chains import float64_steps
    from split_vae_torch.train.loop import build_vae_model
    from split_vae_torch.train.steps import augment, make_vae_train_step, normalize_images

    rng = np.random.RandomState(4)
    batches = [torch.from_numpy(rng.randint(0, 256, (cfg.batch_size, *hw, 3)).astype(np.uint8))
               for _ in range(CHAIN_STEPS)]
    cpu, tx = build_vae_model(cfg, hw, device="cpu")
    card, _ = build_vae_model(cfg, hw, device=device)
    card.load_state_dict(cpu.state_dict())
    cpu.double()
    card.double()
    replays = []
    for i, batch in enumerate(batches):
        rec = RecordingNoise(Noise(torch.Generator().manual_seed(30 + i), dtype=torch.float64))
        with torch.no_grad():
            cpu(augment(cfg, normalize_images(batch, "tanh").double(), rec), True, rec)
        replays.append(rec.drawn)
    with float64_steps():  # eager: a float64 step takes the foreach optimizer
        runs = [run_chain(torch, model, tx, make_vae_train_step(cfg).eager, batches, replays,
                          GM_CHAIN_START, dev) for model, dev in ((cpu, "cpu"), (card, device))]
    hold_chain(label, f"B={cfg.batch_size}, {hw[0]} px, patch {cfg.patch_size}, float64, "
               f"from count {GM_CHAIN_START}", [n for n, _ in cpu.named_parameters()], *runs)


KERNELS = ("render_fwd", "render_bwd", "crop_fwd", "crop_bwd", "render_windowed_fwd",
           "render_windowed_bwd")


_LAUNCHES_FROM = {}


def reset_launches():
    """Marks the kernels' launch counters (``core/tracing.py``) as the base
    that ``read_launches`` counts from."""
    from split_vae_torch.core import tracing
    _LAUNCHES_FROM.clear()
    _LAUNCHES_FROM.update(tracing.counters())


def read_launches():
    """Each kernel's launches since ``reset_launches``, under ``KERNELS``' names."""
    from split_vae_torch.core import tracing
    now = tracing.counters()
    counter = {k: ".".join(k.rsplit("_", 1)) for k in KERNELS}
    return {k: now.get(c, 0) - _LAUNCHES_FROM.get(c, 0) for k, c in counter.items()}


FUSED_BY_PATH = {}  # the fused optimizer's launches (kernels/adam.py) on each main path


def read_counts(names):
    """The counters ``names`` since ``reset_launches``."""
    from split_vae_torch.core import tracing
    now = tracing.counters()
    return {k: now.get(k, 0) - _LAUNCHES_FROM.get(k, 0) for k in names}


def read_fused() -> int:
    """The fused optimizer's launches (``optim.fused``) since ``reset_launches``."""
    return read_counts(("optim.fused",))["optim.fused"]


def hold_graphed(name, steps, scrambles=0):
    """Fails unless the train step recorded once and replayed its graph at
    every later step, and LGGlimpseSPAIR scrambled its glimpses once a step."""
    got = read_counts(("step.graphed", "step.eager", "glimpse.scramble"))
    want = {"step.graphed": steps - 1, "step.eager": 1, "glimpse.scramble": scrambles}
    if got != want:
        fail(f"{name}: the train steps took the paths {got}, not {want}")
    return got


def hold_fused_optimizer(name, launched, steps):
    """Fails unless the optimizer took its fused kernels (three launches a
    step) on each of ``steps`` train steps; keeps the count for the kernels
    line."""
    if launched < 3 * steps:
        fail(f"{name}: the fused optimizer launched {launched} kernels in {steps} train steps")
    FUSED_BY_PATH[name] = launched


COUNT_PRIOR_BY_PATH = {}  # the count prior's launches (kernels/count_prior.py) on each main path


def hold_count_prior(name, steps):
    """Fails unless the count prior's kernels ran once each way in each of
    ``steps`` train steps (0 on a VAE path), replays included."""
    got = read_counts(("count_prior.fwd", "count_prior.bwd"))
    if got != {"count_prior.fwd": steps, "count_prior.bwd": steps}:
        fail(f"{name}: the count prior's kernels launched {got} in the train steps, not "
             f"{steps} each way")
    COUNT_PRIOR_BY_PATH[name] = got["count_prior.fwd"] + got["count_prior.bwd"]


def run_steps(torch, np, name, train_step, state, batches):
    """TRAIN_STEPS train steps on the two batches in turn, the peak device
    memory counted from their start; returns the state and the losses after
    checking that all is finite and no update was skipped."""
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(TRAIN_STEPS):
        state, metrics = train_step(state, batches[i % 2])
        losses.append(metrics["total_loss"])
    losses = [v.item() for v in losses]
    notfinite = int(metrics["notfinite_updates"].item())
    log(f"{name}: {len(losses)} steps; losses {losses[0]:.2f} -> {losses[-1]:.2f}; "
        f"notfinite_updates {notfinite}")
    if not all(np.isfinite(losses)):
        fail(f"{name}: non-finite loss {losses}")
    if notfinite != 0:
        fail(f"{name}: {notfinite} updates were skipped as non-finite")
    return state, losses


class CountInterpMatrix:
    """Counts the calls of kernels/crop.py::interp_matrix (the dense
    interpolation weights) under every name the port's modules bind it to,
    while the block lasts: ``calls`` with autograd on (a train step's),
    ``no_grad_calls`` under ``torch.no_grad`` (the eval step's unfused
    forward, the reference's fused=False)."""

    def __enter__(self):
        import torch

        from split_vae_torch.kernels import crop

        self.calls, self.no_grad_calls, original = 0, 0, crop.interp_matrix

        def counted(*args, **kwargs):
            if torch.is_grad_enabled():
                self.calls += 1
            else:
                self.no_grad_calls += 1
            return original(*args, **kwargs)

        self.bound = [(m, k) for m in list(sys.modules.values())
                      if getattr(m, "__name__", "").startswith("split_vae_torch")
                      for k, v in list(vars(m).items()) if v is original]
        for m, k in self.bound:
            setattr(m, k, counted)
        self.original = original
        return self

    def __exit__(self, *exc):
        for m, k in self.bound:
            setattr(m, k, self.original)
        return False


def check_float32_state(name, state):
    """The parameters and the optimizer's floating state are float32 after the
    steps, whatever the compute dtype."""
    import torch

    from split_vae_torch.core.state import tree_tensors

    held = list(state.model.parameters()) + [
        t for t in tree_tensors(state.opt_state) if t.is_floating_point()]
    other = {str(t.dtype) for t in held if t.dtype != torch.float32}
    if other:
        fail(f"{name}: parameters or optimizer state in {sorted(other)} after the steps")


def run_path(torch, np, name, cfg, windowed_render=False):
    """A SPAIR-family main path at full width: train steps through the kernels
    with the launch counts set to 0 before and read after, one eval step.
    ``windowed_render`` takes the row-windowed render pair, and then the
    full-canvas pair must not be launched. Returns the launch counts of the
    train steps and their losses."""
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.optim import spair_optimizer
    from split_vae_torch.train.steps import make_spair_eval_step, make_spair_train_step

    model = get_spair_model(cfg, device="cuda")
    state = create_train_state(model, spair_optimizer(cfg.learning_rate), seed=cfg.seed)
    train_step = make_spair_train_step(cfg, windowed_render=windowed_render)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.uniform(0, 1, (cfg.batch_size,) + tuple(cfg.image_size))
                                .astype(np.float32)).cuda() for _ in range(2)]
    log(f"{name} ({cfg.model}, {cfg.object_size}-px objects, "
        f"{'row-windowed' if windowed_render else 'full-canvas'} render, {cfg.compute_dtype}): "
        f"B={cfg.batch_size}, {sum(p.numel() for p in model.parameters())} params")
    reset_launches()
    with CountInterpMatrix() as dense:
        state, losses = run_steps(torch, np, name, train_step, state, batches)
    launches = read_launches()
    paths = hold_graphed(name, len(losses),
                         len(losses) if cfg.model == "lg_glimpse_spair" else 0)
    hold_fused_optimizer(name, read_fused(), len(losses))
    hold_count_prior(name, len(losses))
    check_float32_state(name, state)
    if dense.calls:
        fail(f"{name}: the train steps built dense interpolation weights ({dense.calls} calls "
             f"of interp_matrix)")
    used, unused = ("render_windowed", "render") if windowed_render else ("render",
                                                                          "render_windowed")
    for kernel, n in launches.items():
        if kernel.rsplit("_", 1)[0] == unused:
            if n != 0:
                fail(f"{name}: {kernel} kernel launched {n} times on a path that takes the "
                     f"{used} pair")
        elif n < len(losses) or (kernel.startswith("crop") and n != len(losses)):
            fail(f"{name}: {kernel} kernel launched {n} times in {len(losses)} steps")
    log(f"{name}: no interp_matrix in the train steps; launches {launches}; paths {paths}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # One eval step with labels (random counts: the weights are random too).
    labels = torch.from_numpy(rng.randint(0, 7, cfg.batch_size).astype(np.float32)).cuda()
    out, ev, _ = make_spair_eval_step(cfg, model)(state.generator, batches[1], labels)
    torch.cuda.synchronize()
    ev = {k: v.item() for k, v in ev.items()}
    if not all(np.isfinite(list(ev.values()))) or not torch.isfinite(out.x_recon).all():
        fail(f"{name}: non-finite eval result {ev}")
    if tuple(out.x_recon.shape) != (cfg.batch_size,) + tuple(cfg.image_size):
        fail(f"{name}: eval x_recon has shape {tuple(out.x_recon.shape)}")
    log(f"{name} eval: total_loss {ev['total_loss']:.2f}, count_acc {ev['count_acc']:.4f}, "
        f"MAE test {ev['MAE test']:.4f}, MAPE_nonzero test {ev['MAPE_nonzero test']:.2f}, "
        f"MAPE test {ev['MAPE test']:.4g}")
    return launches, losses


def run_vae_path(torch, np, name, cfg, hw):
    """A VAE-family main path at full width (LGVae, LGGMVae): train steps on
    uint8 batches, one eval step. No hand-written kernel lies on it; the
    launch counts are read all the same, must be 0, and are returned, with
    the losses."""
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.train.loop import build_vae_model
    from split_vae_torch.train.steps import make_vae_eval_step, make_vae_train_step

    model, tx = build_vae_model(cfg, hw, device="cuda")
    state = create_train_state(model, tx, seed=cfg.seed)
    train_step = make_vae_train_step(cfg)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(0, 255, (cfg.batch_size, *hw, 3)).astype(np.uint8))
               .cuda() for _ in range(2)]
    gm = f", y_size {cfg.y_size}, tau {cfg.tau}, alpha {cfg.alpha}" if cfg.model != "lgvae" else ""
    log(f"{name} ({cfg.model}, {hw[0]}x{hw[1]}, patch {cfg.patch_size}, latents "
        f"{cfg.global_latent_dims}/{cfg.local_latent_dims}, beta {cfg.beta}{gm}, "
        f"{cfg.compute_dtype}): "
        f"B={cfg.batch_size}, {sum(p.numel() for p in model.parameters())} params")
    reset_launches()
    state, losses = run_steps(torch, np, name, train_step, state, batches)
    launches = read_launches()
    hold_graphed(name, len(losses))
    hold_fused_optimizer(name, read_fused(), len(losses))
    hold_count_prior(name, 0)
    check_float32_state(name, state)
    if any(launches.values()):
        fail(f"{name}: a SPAIR kernel was launched on the {cfg.model} path: {launches}")
    log(f"{name}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    out, ev, images = make_vae_eval_step(cfg, model)(state.generator, batches[1])
    torch.cuda.synchronize()
    ev = {k: v.item() for k, v in ev.items()}
    if not all(np.isfinite(list(ev.values()))) or not all(torch.isfinite(t).all() for t in out):
        fail(f"{name}: non-finite eval result {ev}")
    if (tuple(out.x_mean.shape) != (cfg.batch_size, *hw, 3)
            or tuple(images.shape) != (cfg.batch_size, *hw, 6)):
        fail(f"{name}: eval x_mean {tuple(out.x_mean.shape)}, images {tuple(images.shape)}")
    log(f"{name} eval: " + ", ".join(f"{k} {v:.4f}" for k, v in ev.items()))
    return launches, losses


# ---------------------------------------------------------------- resize2x -> conv

# The fused resize2x -> conv sites of the main paths (nn/pixel_shuffle.py):
# (label, fused form, batch, source side, Cin, Cout, kernel side). The SPAIR
# object nets run at B*K = 256 * 16 objects.
RESIZE_CONV_SITES = (
    ("P1 ObjDecoder.Conv_1", "resize2x_conv", 4096, 8, 64, 32, 3),
    ("P1 ObjDecoder.Conv_2", "resize2x_conv", 4096, 16, 32, 4, 3),
    ("P1 ObjDecoder.Conv_1, dilated form", "resize2x_conv_any", 4096, 8, 64, 32, 3),
    ("P1 ObjDecoder.Conv_2, dilated form", "resize2x_conv_any", 4096, 16, 32, 4, 3),
    ("P3 ObjDecoder/GlimpseDecoder.Conv_1", "resize2x_conv", 4096, 7, 64, 32, 3),
    ("P3 ObjDecoder.Conv_2", "resize2x_conv", 4096, 14, 32, 4, 3),
    ("P3 GlimpseDecoder.Conv_2", "resize2x_conv", 4096, 14, 32, 3, 3),
    ("P2/P3 BackgroundModel.Conv_4", "resize2x_conv", 256, 6, 128, 64, 3),
    ("P2/P3 BackgroundModel.Conv_5", "resize2x_conv", 256, 12, 64, 32, 3),
    ("P2/P3 BackgroundModel.Conv_6", "resize2x_conv", 256, 24, 32, 3, 3),
    ("P5 ConvDecoder.Conv_3", "resize2x_conv_any", 64, 32, 32, 6, 6),
)
# Each tensor's largest gap to the chain, over its largest magnitude: float32
# (TF32 off) sums the same products in another order; bfloat16 rounds other
# intermediates (the chain its upsampled tensor and that tensor's gradient).
RESIZE_CONV_LIMITS = {"float32": (1e-5, 1e-4), "bfloat16": (2 ** -5, 2 ** -5)}  # output, grads


def resize_conv_sites(torch):
    """The fused forms (and their mixed forms) against the chain on the card
    at every production site, float32 and bfloat16, the output and the
    gradients of x, the kernel and the bias (RESIZE_CONV_LIMITS). Logs every
    gap, then fails on any miss."""
    from split_vae_torch.nn import pixel_shuffle as ps

    gen = torch.Generator(device="cuda").manual_seed(0)
    misses = []
    log("resize2x -> conv sites (nn/pixel_shuffle.py), the fused and mixed forms against the "
        "chain on the card (each tensor's largest gap over its largest magnitude):")
    for label, form, b, s, cin, cout, k in RESIZE_CONV_SITES:
        x = torch.randn(b, s, s, cin, device="cuda", generator=gen)
        w = torch.randn(cout, cin, k, k, device="cuda", generator=gen) * (
            2.0 / (k * k * (cin + cout))) ** 0.5
        bias = torch.randn(cout, device="cuda", generator=gen) * 0.1
        cot = torch.randn(b, 2 * s, 2 * s, cout, device="cuda", generator=gen)
        forms = {"fused": getattr(ps, form), "mixed": getattr(ps, form + "_mixed")}
        for dtype, (out_limit, grad_limit) in RESIZE_CONV_LIMITS.items():
            ins = [t.detach().to(getattr(torch, dtype)).requires_grad_() for t in (x, w, bias)]
            g_out = cot.to(ins[0].dtype)

            def run(fn):
                out = fn(*ins)
                return [out.detach()] + list(torch.autograd.grad(out, ins, g_out))

            ref = run(ps.resize2x_conv_chain)
            line = []
            for name, fn in forms.items():
                gaps = [((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                        for g, r in zip(run(fn), ref)]
                line.append(f"{name} out {gaps[0]:.3g}, dx {gaps[1]:.3g}, dK {gaps[2]:.3g}, "
                            f"db {gaps[3]:.3g}")
                if not (gaps[0] <= out_limit and max(gaps[1:]) <= grad_limit):
                    misses.append(f"{label} {dtype} {name}: {gaps}")
            log(f"  {label} ({form}, x [{b},{s},{s},{cin}], Cout {cout}, k {k}) {dtype}: "
                + "; ".join(line))
            del ref, ins, g_out
        del x, w, bias, cot
        torch.cuda.empty_cache()
    if misses:
        fail("resize2x -> conv against the chain on the card: " + "; ".join(misses))
    log(f"resize2x -> conv sites: every form within {RESIZE_CONV_LIMITS} of the chain")


# The reference command of config #5 (split_vae_tpu/cli/spair_main.py:3-7) and
# the config-#2 flags (bench.py:81-82), each without its step count.
CONFIG5_ARGV = ["--dataset", "cub_ckb_rot_6", "--z_bg_beta", "1", "--patch_size", "8",
                "--latent_size", "64", "--bg_latent_size", "64", "--local_latent_size", "64",
                "--model", "lg_spair", "-split_z_l", "--z_what_beta", "0.5", "-concat_z_what",
                "-dense_local", "-dense_bg"]
CONFIG2_ARGV = ["--dataset", "celeba64", "-no_label", "--beta", "30", "--patch_size", "8",
                "--global_latent_dims", "128", "--local_latent_dims", "128", "--batch_size", "64"]
FIRST_STEPS, RESUMED_STEPS = 40, 60


class Tee(io.TextIOBase):
    """Writes to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        return self.buf.write(text)

    def flush(self):
        self.out.flush()


def read_records(run_dir: str):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_cli_run(np, name, tmp, run, steps, prefixes):
    """A run's records fall at ``steps`` under every prefix, all finite, with
    no update skipped; its checkpoints (at most 3) and final weights exist."""
    run_dir = os.path.join(tmp, "output", run)
    records = read_records(run_dir)
    for prefix in prefixes:
        got = [r["step"] for r in records if any(k.startswith(prefix) for k in r)]
        if got != steps:
            fail(f"{name}: {run}'s {prefix} records at steps {got}, not {steps}")
    for r in records:
        values = [v for k, v in r.items() if k not in ("step", "time")]
        if not values or not np.isfinite(values).all():
            fail(f"{name}: a record that is empty or not finite at step {r['step']}: {r}")
        if r.get("train/notfinite_updates", 0.0) != 0.0:
            fail(f"{name}: {r['train/notfinite_updates']} updates skipped as non-finite by step "
                 f"{r['step']}")
    found = os.listdir(os.path.join(run_dir, "checkpoints"))
    if not 1 <= len(found) <= 3 or any(not f.endswith(".pt") for f in found):
        fail(f"{name}: {run}'s checkpoints are {found}")
    if not os.path.isfile(os.path.join(tmp, "models", run + ".pt")):
        fail(f"{name}: no final weights models/{run}.pt")
    return records


# The PNGs of one eval step: {name: (height, width, channels)} of the files the
# JAX loop writes for the model and flags (split_vae_tpu/train/loop.py:248-277,
# :343-389), and the cluster galleries, whose clusters depend on the data:
# (name prefix, the set of clusters allowed, rows, the image width, the most
# images a gallery shows).
SPAIR_N = 10  # the SPAIR writers' images (n=10)


def spair_pngs(hw, grid, object_size, tests, batch, model):
    from split_vae_torch.viz.png import PANEL_GAP  # white columns between a figure's panels

    h, w = hw
    k, n = grid * grid, min(SPAIR_N, batch)
    decomposition = (h * (k + 2), 3 * w * n + 2 * PANEL_GAP, 3)  # three panels

    def at(step):
        out = {f"train_recon_it_{step}.png": decomposition}
        for t in range(tests):
            s = f"_it_{step}_{t}"
            out[f"x_reconstrcution_test{s}.png"] = decomposition
            out[f"x_reconstrcution_bbox{s}.png"] = (3 * h, n * w, 3)
            out[f"glimpses{s}.png"] = (object_size * k, 3 * object_size * n + 2 * PANEL_GAP, 3)
            if model == "lg_spair":
                out[f"x_hat_reconstrcution_test{s}.png"] = (2 * h, n * w, 3)
            elif model == "lg_glimpse_spair":
                out[f"glimpses_local{s}.png"] = (object_size * k,
                                                 2 * object_size * n + PANEL_GAP, 3)
        return out, None
    return at


def vae_pngs(hw, model, svhn, viz, last_batch, y_size):
    h, w = hw
    grid = (10 * h, 10 * w, 3)

    def at(step):
        if model == "gmvae":
            return {}, None
        out = {f"generate_it_{step}.png": grid, f"vary_lower_it_{step}.png": grid,
               f"x_hat_vary_lower_it_{step}.png": grid, f"vary_upper_it_{step}.png": grid,
               f"x_reconstruction_test_it_{step}.png": (2 * h, 10 * w, 3),
               f"x_hat_reconstruction_test_it_{step}.png": (2 * h, 10 * w, 3)}
        if svhn:
            out[f"style_transfer_it_{step}.png"] = (3 * h, 10 * w, 3)
        elif last_batch >= 20:
            out[f"style_transfer_celeba_it_{step}.png"] = (4 * h, 10 * w, 3)
        if not (viz and model == "lggmvae"):
            return out, None
        for stem in ("generate_cluster_fix_zl", "generate_cluster", "generate_multi_cluster"):
            out[f"{stem}_it_{step}.png"] = grid
        return out, (f"unseen_cluster__it_{step}_", range(y_size), h, w, 7)
    return at


def check_pngs(np, name, run_dir, steps, expected):
    """Each eval step's PNG names are the JAX loop's (``expected(step)``), and
    each file decodes with viz/png.py at its canvas's shape. Returns the
    files' count and bytes."""
    import re

    from split_vae_torch.viz.png import read_png

    files = [f for f in os.listdir(run_dir) if f.endswith(".png")]
    by_step = {}
    for f in files:
        m = re.search(r"_it_(\d+)(?:_\d+)?\.png$", f)
        if not m:
            fail(f"{name}: {f} is not a file of an eval step")
        by_step.setdefault(int(m.group(1)), []).append(f)
    if sorted(k for k, v in by_step.items() if v) != sorted(
            s for s in steps if expected(s)[0]):
        fail(f"{name}: PNGs at steps {sorted(by_step)}, evals at {steps}")
    nbytes = 0
    for step in steps:
        fixed, gallery = expected(step)
        got = set(by_step.get(step, []))
        galleries = {f for f in got if gallery and f.startswith(gallery[0])}
        if got - galleries != set(fixed) or (gallery and not galleries):
            fail(f"{name}: PNGs at step {step} are {sorted(got)}, the JAX loop writes "
                 f"{sorted(fixed)}" + (f" and {gallery[0]}<cluster>.png" if gallery else ""))
        for f in sorted(got):
            image, _ = read_png(os.path.join(run_dir, f))
            shape = image.shape if image.ndim == 3 else image.shape + (1,)
            if f in galleries:
                prefix, clusters, rows, width, most = gallery
                c = int(f[len(prefix):-4])
                ok = (c in clusters and shape[0] == rows and shape[2] == 3
                      and shape[1] % width == 0 and 1 <= shape[1] // width <= most)
            else:
                ok = shape == fixed[f]
            if not ok:
                fail(f"{name}: {f} decodes to {shape}"
                     + ("" if f in galleries else f", the canvas is {fixed[f]}"))
            nbytes += os.path.getsize(os.path.join(run_dir, f))
    return len(files), nbytes


def run_cli_path(torch, np, name, main, argv, test_prefixes, first=FIRST_STEPS,
                 resumed=RESUMED_STEPS, prepare=None, pngs=None):
    """A CLI driven in-process in a temporary directory (the working directory,
    data_dir and output_dir): ``first`` steps with evals and checkpoints
    every 20, then, unless ``resumed`` is None, ``--resume`` from that run's
    checkpoints to ``resumed``. ``prepare(tmp)`` runs first (it may put files
    there). The launch counts are set to 0 before and read after both runs;
    on the SPAIR path each train step launches the render pair and the crop's
    backward once and builds no dense weights. Logs each checkpoint's write
    time and size and the peak device memory; returns the launch counts and
    the runs' records.

    ``pngs`` (``spair_pngs``, ``vae_pngs``) gives each eval step's PNGs: every
    run's are checked by ``check_pngs``, and a ``[viz] ... skipped`` line in
    the output (the loop's guard around its figures) fails the path. The
    loop's viz functions are timed (the device synchronized around them) for
    the viz ms an eval."""
    import contextlib
    import tempfile

    from split_vae_torch.core import checkpoint as ckpt
    from split_vae_torch.train import loop

    spair = test_prefixes != ("test/",)
    original, saves = ckpt.save_checkpoint, []

    def timed_save(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = original(*args, **kwargs)
        saves.append((time.perf_counter() - t0, os.path.getsize(path)))
        return path

    viz_ms, viz_fns = [], ("_vae_visualize", "_spair_train_plot", "_spair_visualize")
    originals = {k: getattr(loop, k) for k in viz_fns}

    def timed_viz(fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                viz_ms.append((time.perf_counter() - t0) * 1e3)
        return timed

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        ckpt.save_checkpoint = timed_save
        for k in viz_fns:
            setattr(loop, k, timed_viz(originals[k]))
        try:
            if prepare is not None:
                prepare(tmp)
            reset_launches()
            with CountInterpMatrix() as dense, contextlib.redirect_stdout(Tee(sys.stdout)) as out:
                common = argv + ["--data_dir", tmp, "--output_dir", os.path.join(tmp, "output")]
                main(common + ["--training_steps", str(first)])
                (run,) = os.listdir(os.path.join(tmp, "output"))
                resume = os.path.join(tmp, "output", run, "checkpoints")
                if resumed is not None:
                    main(common + ["--training_steps", str(resumed), "--resume", resume])
        finally:
            ckpt.save_checkpoint = original
            for k in viz_fns:
                setattr(loop, k, originals[k])
            os.chdir(cwd)
        launches, fused = read_launches(), read_fused()
        prefixes = ("train/",) + test_prefixes
        evals = list(range(20, first + 1, 20))
        records = check_cli_run(np, name, tmp, run, evals, prefixes)
        runs = [(run, evals)]
        if resumed is not None:
            (second,) = set(os.listdir(os.path.join(tmp, "output"))) - {run}
            records += check_cli_run(np, name, tmp, second, [resumed], prefixes)
            runs.append((second, [resumed]))
            if f"Resumed from {resume} at step {first}" not in out.buf.getvalue():
                fail(f"{name}: the resumed run did not print 'Resumed from {resume} at step "
                     f"{first}'")
        skipped = [line for line in out.buf.getvalue().splitlines()
                   if line.startswith("[viz]") and "skipped" in line]
        if skipped:
            fail(f"{name}: a figure failed: {skipped}")
        if pngs is not None:
            n_png = n_bytes = 0
            for run_name, steps_at in runs:
                c, b = check_pngs(np, name, os.path.join(tmp, "output", run_name), steps_at,
                                  pngs)
                n_png, n_bytes = n_png + c, n_bytes + b
            n_evals = sum(len(steps_at) for _, steps_at in runs)
            log(f"{name}: {n_png} PNGs in {n_evals} evals, {n_bytes / 1e6:.3f} MB, each the JAX "
                f"loop's name and its canvas's shape; viz {sum(viz_ms) / n_evals:.1f} ms an eval "
                f"(" + ", ".join(f"{t:.1f}" for t in viz_ms) + " ms a call)")
    steps = (first + 1) + (0 if resumed is None else resumed - first + 1)
    hold_fused_optimizer(name, fused, steps)
    if dense.calls:
        fail(f"{name}: the train steps built dense interpolation weights ({dense.calls} calls of "
             f"interp_matrix with autograd on)")
    if spair:
        for kernel in ("render_fwd", "render_bwd", "crop_bwd"):
            if launches[kernel] != steps:
                fail(f"{name}: {kernel} launched {launches[kernel]} times in {steps} train steps")
        if launches["crop_fwd"] < steps or launches["render_windowed_fwd"] \
                or launches["render_windowed_bwd"]:
            fail(f"{name}: launches {launches} in {steps} train steps")
    elif any(launches.values()):
        fail(f"{name}: a SPAIR kernel was launched on a VAE path: {launches}")
    log(f"{name}: {steps} train steps through the CLI; launches {launches}; interp_matrix "
        f"{dense.calls} calls with autograd on, {dense.no_grad_calls} under no_grad (the eval "
        f"sweeps' unfused forwards); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{name}: checkpoints written: " + ", ".join(
        f"{t * 1e3:.1f} ms for {size / 1e6:.1f} MB" for t, size in saves))
    return launches, records


# The probe's seven columns (train/probes.py); LGVae logs the first five.
PROBE_KEYS = ("classifier_recon_acc", "classifier_random_z_l_acc", "classifier_random_z_g_acc",
              "probe_random_z_l_acc_rangefix", "probe_random_z_g_acc_rangefix",
              "probe_swapped_y_z_g_acc_rangefix", "probe_swapped_y_transfer_acc_rangefix")
DIGITS_CLASSIFIER = "svhn_classifier_weights_synth_digits_8192.msgpack"
CONFIG3_ARGV = ["--model", "lggmvae", "--beta", "40", "--alpha", "40", "--y_size", "30",
                "--patch_size", "4", "--dataset", "svhn", "-synthetic_data", "--synthetic_style",
                "digits", "--synthetic_size", "8192"]


def run_classifier_cli(torch, np):
    """P9, first part: classifier_main --epochs 1 -synthetic_data in a
    temporary directory; its losses finite, its .pt written, no kernel
    launched. Returns the launch counts."""
    import contextlib
    import re
    import tempfile

    from split_vae_torch.cli import classifier_main

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        reset_launches()
        try:
            with contextlib.redirect_stdout(Tee(sys.stdout)) as out:
                classifier_main.main(["--epochs", "1", "-synthetic_data", "--data_dir", tmp])
        finally:
            os.chdir(cwd)
        m = re.search(r"classifier epoch 1: train loss (\S+) acc (\S+) test acc (\S+)",
                      out.buf.getvalue())
        if not m or not np.isfinite([float(v) for v in m.groups()]).all():
            fail(f"P9: classifier_main printed no finite epoch line: {out.buf.getvalue()[-500:]}")
        weights = os.path.join(tmp, "models", "svhn_classifier_weights_synth_blobs_512.pt")
        if not os.path.isfile(weights):
            fail(f"P9: classifier_main wrote no {os.path.relpath(weights, tmp)}")
        launches = read_launches()
    if any(launches.values()):
        fail(f"P9: a SPAIR kernel was launched by classifier_main: {launches}")
    log(f"P9 classifier_main: one epoch of 640 images (train and test); train loss "
        f"{m.group(1)}, acc {m.group(2)}, test acc {m.group(3)}")
    return launches


def check_probe_records(name, records, probe_keys, min_classifier_acc=0.9):
    """Every test/ record holds the cluster accuracy and exactly ``probe_keys``
    of the probe columns; every meta/classifier_test_acc is at least
    ``min_classifier_acc``."""
    tests = [r for r in records if "test/total_loss" in r]
    metas = [r["meta/classifier_test_acc"] for r in records if "meta/classifier_test_acc" in r]
    if not tests or not metas:
        fail(f"{name}: {len(tests)} test records, {len(metas)} meta records")
    for r in tests:
        got = {k for k in PROBE_KEYS if "test/" + k in r}
        if "test/classifier_cluster_acc" not in r or got != set(probe_keys):
            fail(f"{name}: the test record at step {r['step']} holds {sorted(r)}")
    if min(metas) < min_classifier_acc:
        fail(f"{name}: meta/classifier_test_acc {metas} below {min_classifier_acc}")
    log(f"{name}: meta/classifier_test_acc {metas}; test/classifier_cluster_acc " + ", ".join(
        f"{r['test/classifier_cluster_acc']:.4f} (step {r['step']})" for r in tests)
        + "; " + ", ".join(f"{k} {tests[-1]['test/' + k]:.4f}" for k in probe_keys))


GM_SPANS = ("forward.gm_encoder", "gm.y")


def run_p17(torch, np, cli_args):
    """P17: config #4 through vae_main with the README's flags
    (``CONFIG4_ARGV``, its step count overridden) on synthetic CelebA 64x64, 40 steps,
    evals and checkpoints every 20, --resume to 60, the -viz PNGs checked,
    with tracing on: the GM encoder's spans open once a forward of the
    encoder (the train steps', the evals' and the figures'), ``gm.y`` inside
    every ``forward.gm_encoder``. Returns the launch counts."""
    from split_vae_torch.cli import vae_main
    from split_vae_torch.core import tracing
    from split_vae_torch.core.config import CONFIG4_ARGV, CONFIG4_IMAGE_HW

    tracing.drain()
    tracing.enable(True)
    try:
        launches, _ = run_cli_path(
            torch, np, "P17", vae_main.main, list(CONFIG4_ARGV) + cli_args, ("test/",),
            pngs=vae_pngs(CONFIG4_IMAGE_HW, "lggmvae", svhn=False, viz=True, last_batch=64,
                          y_size=30))
    finally:
        tracing.enable(False)
        records = tracing.drain()
    calls = {name: sum(r.name == name for r in records) for name in GM_SPANS + ("step",)}
    nested = all(r.parent == "forward.gm_encoder" for r in records if r.name == "gm.y")
    if not nested or calls["gm.y"] != calls["forward.gm_encoder"] \
            or calls["forward.gm_encoder"] <= calls["step"]:
        fail(f"P17: span calls {calls}, gm.y always inside forward.gm_encoder: {nested}")
    log(f"P17: span calls over both runs {calls} (train steps, evals and figures)")
    return launches


# ---------------------------------------------------------------- P13, P14

P13_STEPS = 3
P13_DRAW = 4096  # normals each process draws from a CUDA generator of one seed
P13_DRAW_SEED = 1234
RANKS = 2


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(fn_name: str, world: int, args: tuple, timeout: float):
    """Runs ``chip_smoke.<fn_name>(rank, world, port, *args)`` in ``world``
    processes of their own, on a free local port; fails on a non-zero exit or
    a time-out, and kills every process it started. Logs each process's
    output."""
    port = free_port()
    code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
            f"chip_smoke.{fn_name}({{}}, {world}, {port}, *{args!r})")
    env = dict(os.environ)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", code.format(r)], cwd=HERE, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        fail(f"{fn_name}: a process ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines()[-40:]:
            log(f"  [{fn_name} rank {r}] {line}")
        if p.returncode != 0:
            fail(f"{fn_name}: rank {r} exited {p.returncode}")


def p13_batches(torch, np, cfg, device):
    """P1's two batches (``run_path``'s), on ``device``."""
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.uniform(0, 1, (cfg.batch_size,) + tuple(cfg.image_size))
                             .astype(np.float32)).to(device) for _ in range(2)]


def p13_steps(torch, np, mesh):
    """P1's configuration, seed and two batches (config #5, global B=256)
    through P13_STEPS train steps on this rank's rows, every rank starting
    from rank 0's state, then keeping its blocks of the weights that the JAX
    rule shards when the mesh has a model group (P15). Returns the losses
    (this rank's), the kernels' launches in the steps, the peak device
    memory, this rank's parameters (blocks) after the steps, and on rank 0
    the 1-rank tensors of every step: the gradients the optimizer saw, the
    parameters and the optimizer state after it."""
    from split_vae_torch.core.config import config5
    from split_vae_torch.core.state import create_train_state, tree_tensors
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.parallel.mesh import (
        broadcast_state_,
        gather_opt_state,
        gather_state_dict,
        infer_param_sharding,
        model_reduce,
        rows,
        shard_state,
    )
    from split_vae_torch.parallel.tensor import all_gather_cat
    from split_vae_torch.train import steps as steps_mod
    from split_vae_torch.train.optim import GradientTransformation, spair_optimizer

    cfg = config5()
    model = get_spair_model(cfg, device=mesh.device)
    sharded = infer_param_sharding(model, mesh)
    tx = spair_optimizer(cfg.learning_rate, model_reduce(mesh, model, sharded))
    seen = []

    def update(grads, state):
        seen.append([g.detach().clone() for g in grads])
        return tx.update(grads, state)

    state = create_train_state(model, GradientTransformation(tx.init, update), seed=cfg.seed)
    broadcast_state_(state, mesh)
    shard_state(state, mesh, sharded)
    names = [n for n, _ in model.named_parameters()]
    shards = {n: state.model.get_submodule(n.rpartition(".")[0]).shard for n in sharded}
    mine = rows(mesh, cfg.batch_size)
    batches = [b[mine] for b in p13_batches(torch, np, cfg, mesh.device)]
    # Eager on one process too: no graph holds the recording (foreach) optimizer.
    train_step = steps_mod.make_spair_train_step(cfg, mesh=mesh).eager
    keep = mesh.rank == 0
    record = {"grads": [], "params": [], "opt": []}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = []
    for i in range(P13_STEPS):
        state, metrics = train_step(state, batches[i % 2])
        losses.append(metrics["total_loss"])
        # The 1-rank tensors.
        grads = [all_gather_cat(g, shards[n], 0) if n in shards else g
                 for n, g in zip(names, seen.pop())]
        full = gather_state_dict(model)
        opt = tree_tensors(gather_opt_state(state))
        if keep:
            record["grads"].append([g.cpu() for g in grads])
            record["params"].append([full[n].detach().cpu() for n in names])
            record["opt"].append([t.cpu() for t in opt])
        del grads, full, opt
    launches = read_launches()
    return dict(record, losses=[v.item() for v in losses],
                notfinite=int(metrics["notfinite_updates"].item()), launches=launches,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, names=names,
                sharded=sharded, blocks=[p.detach().cpu() for p in model.parameters()],
                params_a_rank=sum(p.numel() for p in model.parameters()))


def emulated_step(torch, cfg, state, batch, generator_state):
    """One step of the P13 ranks' function computed in this process, without
    the transport: each half of the batch with that rank's rows of the draws
    (the generator set to ``generator_state`` for each) and its render seed,
    the two halves' gradients summed and halved, as the ranks' all-reduce
    does, then one update. Returns the gradients."""
    from split_vae_torch.core.noise import Noise
    from split_vae_torch.parallel.mesh import Mesh, rows
    from split_vae_torch.train.losses import spair_loss
    from split_vae_torch.train.steps import model_inputs, normalize_images

    params = state.params
    sums = [torch.zeros_like(p) for p in params]
    for r in range(RANKS):
        state.generator.set_state(generator_state)
        noise = Noise(state.generator, rank=r, world=RANKS)
        half = batch[rows(Mesh(rank=r, world=RANKS), cfg.batch_size)]
        images = model_inputs(cfg, normalize_images(half, "unit"), noise)
        total, _ = spair_loss(state.model(images, True, noise), images, cfg, state.step,
                              training=True)
        for acc, g in zip(sums, torch.autograd.grad(total, params, allow_unused=True)):
            if g is not None:
                acc.add_(g)
    grads = [g / RANKS for g in sums]
    state.apply_gradients(grads)
    return grads


def compute_by_blocks(torch, layer, count: int) -> None:
    """Makes the Dense or Conv ``layer`` compute as a model group of
    ``count`` ranks computes it, in this process: each block of its weight's
    output rows through the unsharded layer on its own (no bias), the blocks
    concatenated along the features, then the bias. Its parameters stay
    whole, and each block's gradient is the one a rank's own product gives."""
    import types

    def forward(self, x):
        outs = []
        for block in self.weight.chunk(count, 0):
            proxy = object.__new__(type(self))
            proxy.__dict__ = dict(self.__dict__, _parameters={"weight": block, "bias": None})
            outs.append(type(self).forward(proxy, x))
        return torch.cat(outs, dim=-1) + self.bias

    layer.forward = types.MethodType(forward, layer)


def p13_emulated(torch, np, device, restart=None, blocks=()):
    """The 2-rank P13 steps computed in this process (``emulated_step``);
    the weights named in ``blocks`` computed as a model group of 2 computes
    them (``compute_by_blocks``: P15's grid). Without ``restart``, one chain
    of P13_STEPS steps from the seeded initialization; with it (a rank's
    record of ``p13_steps``), step t from the ranks' own parameters and
    optimizer state after step t - 1, so that each step is held alone.
    Returns each step's gradients, the parameters after it, and the
    generator's state at its start."""
    from split_vae_torch.core.config import config5
    from split_vae_torch.core.state import create_train_state, tree_tensors
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.optim import spair_optimizer

    cfg = config5()
    model = get_spair_model(cfg, device=device)
    for name in blocks:
        compute_by_blocks(torch, model.get_submodule(name.rpartition(".")[0]), 2)
    state = create_train_state(model, spair_optimizer(cfg.learning_rate), seed=cfg.seed)
    batches = p13_batches(torch, np, cfg, device)
    out = {"grads": [], "params": [], "gens": []}
    for i in range(P13_STEPS):
        gen = state.generator.get_state() if restart is None else restart["gens"][i]
        if restart is not None and i > 0:
            with torch.no_grad():
                for p, saved in zip(state.params, restart["params"][i - 1]):
                    p.copy_(saved)
                for t, saved in zip(tree_tensors(state.opt_state), restart["opt"][i - 1]):
                    t.copy_(saved)
            state.step = i
        grads = emulated_step(torch, cfg, state, batches[i % 2], gen)
        out["gens"].append(gen)
        out["grads"].append([g.cpu() for g in grads])
        out["params"].append([p.detach().cpu() for p in state.params])
    return out


def p13_rank(rank, world, port, out, num_model=1):
    """A P13 (P15: ``num_model`` 2) process: a gloo group of ``world``
    processes on the one card (NCCL refuses two ranks on one GPU), a draw
    from a CUDA generator of a fixed seed, then ``p13_steps``; saves the
    results for the parent."""
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import torch.distributed as dist

    from split_vae_torch.parallel import mesh as mesh_mod
    from split_vae_torch.train.steps import use_fp32

    torch.cuda.set_device(0)
    use_fp32()
    mesh_mod.maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = mesh_mod.create_mesh(num_model=num_model, device=torch.device("cuda", 0))
    draw = torch.randn(P13_DRAW, generator=torch.Generator("cuda").manual_seed(P13_DRAW_SEED),
                       device="cuda").cpu()
    result = p13_steps(torch, np, mesh)
    result.update(draw=draw, backend=mesh.backend, world=mesh.world,
                  grid=(mesh.data_rank, mesh.model_rank))
    torch.save(result, os.path.join(out, f"p13_rank{rank}.pt"))
    print(f"rank {rank} of {mesh.world} ({mesh.backend}), data index {mesh.data_rank}, model "
          f"index {mesh.model_rank}: losses {result['losses']}", flush=True)
    dist.destroy_process_group()


def norm_gap(a, b) -> float:
    """|a - b| / |b| in the L2 norm."""
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def adam_gap(torch, names, params, ref_params, ref_grads):
    """The largest |params - ref_params| where |ref_grads| >= 1e-5 (Adam's
    rule), and the tensor that holds it."""
    worst, at = 0.0, None
    for name, pn, pr, g in zip(names, params, ref_params, ref_grads):
        d = torch.where(g.abs() >= 1e-5, (pn - pr).abs(), torch.zeros_like(pr)).max().item()
        if d > worst:
            worst, at = d, name
    return worst, at


def hold_each_step(torch, np, label, names, ranks_record, chain, device, blocks=()):
    """The check of P13_STEPS steps that can fail (a fault at any step moves
    it): each step of the ranks against the ranks' function computed in this
    process from the ranks' own state before that step
    (``p13_emulated(restart=...)``): the gradients within 1e-5 of a tensor's
    L2 norm, the parameters after it at Adam's rule (atol 1e-5 where |g| >=
    1e-5). Beside it, the same against the emulation's own chain (logged,
    not held: where the two part). Returns the misses."""
    again = p13_emulated(torch, np, device, restart=dict(ranks_record, gens=chain["gens"]),
                         blocks=blocks)
    missed, logged = [], []
    for t in range(P13_STEPS):
        grad_gap = max(norm_gap(g, e) for g, e in zip(ranks_record["grads"][t],
                                                       again["grads"][t]))
        step_gap, at = adam_gap(torch, names, ranks_record["params"][t], again["params"][t],
                                again["grads"][t])
        chain_gap, chain_at = adam_gap(torch, names, ranks_record["params"][t],
                                       chain["params"][t], chain["grads"][t])
        chain_grad = max(norm_gap(g, e) for g, e in zip(ranks_record["grads"][t],
                                                         chain["grads"][t]))
        logged.append(f"step {t + 1}: gradients {grad_gap:.3g}, parameters {step_gap:.3g} "
                      f"({at}); the chain's {chain_grad:.3g}, {chain_gap:.3g} ({chain_at})")
        if not grad_gap <= 1e-5:
            missed.append(f"step {t + 1}'s gradients lie {grad_gap:.3g} of a norm from the "
                          f"ranks' function computed here from their state (> 1e-5)")
        if not step_gap <= 1e-5:
            missed.append(f"{at} after step {t + 1} differs by {step_gap:.3g} > 1e-5 from the "
                          f"ranks' function computed here from their state, where |g| >= 1e-5")
    log(f"{label} each step against the ranks' function computed in one process from the "
        f"ranks' state before it (held: gradients 1e-5 of a norm, parameters 1e-5 where |g| >= "
        f"1e-5), and against that function's own {P13_STEPS}-step chain (logged): "
        + "; ".join(logged))
    return missed


def run_p13(torch, np):
    """P13: LG-SPAIR at config #5, full width, in 2 processes on the one card
    (gloo), 128 rows each of the global batch of 256, against the same steps
    in one process, and against the two halves' steps computed here (what
    the 2 ranks compute, without the transport, ``p13_emulated``): its own
    chain, and each step again from the ranks' state. Logs every comparison,
    then fails on any that missed. Returns the two ranks' launches summed,
    and the references P15 reuses: the 1-process run and the chain."""
    import tempfile

    from split_vae_torch.parallel.mesh import Mesh

    cuda0 = torch.device("cuda", 0)
    one = p13_steps(torch, np, Mesh(device=cuda0))
    chain = p13_emulated(torch, np, cuda0)
    split, split_params1, split_params = chain["grads"][0], chain["params"][0], chain["params"][-1]
    draw = torch.randn(P13_DRAW, generator=torch.Generator("cuda").manual_seed(P13_DRAW_SEED),
                       device="cuda").cpu()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as out:
        spawn_ranks("p13_rank", RANKS, (out,), timeout=600)
        ranks = [torch.load(os.path.join(out, f"p13_rank{r}.pt"), weights_only=False)
                 for r in range(RANKS)]
    missed = []
    for r, res in enumerate(ranks):
        if not torch.equal(res["draw"], draw):
            missed.append(f"rank {r}'s draw from a CUDA generator seeded {P13_DRAW_SEED} is not "
                          f"this process's")
        if res["notfinite"] or not np.isfinite(res["losses"]).all():
            missed.append(f"rank {r}: losses {res['losses']}, {res['notfinite']} skipped updates")
        for kernel, n in res["launches"].items():
            if n != (0 if kernel.startswith("render_windowed") else P13_STEPS):
                missed.append(f"rank {r} launched {kernel} {n} times in {P13_STEPS} steps")
    names = one["names"]
    unequal = [name for name, a, b in zip(names, ranks[0]["blocks"], ranks[1]["blocks"])
               if not torch.equal(a, b)]
    if unequal:
        missed.append(f"the ranks' parameters differ after the steps: {unequal[:5]}")
    losses = [sum(res["losses"][i] for res in ranks) / RANKS for i in range(P13_STEPS)]
    for i, (got, want) in enumerate(zip(losses, one["losses"])):
        rtol = 1e-5 if i == 0 else 1e-4
        if not abs(got - want) <= rtol * abs(want):
            missed.append(f"step {i + 1}'s loss, the ranks' mean {got}, is not the 1-process "
                          f"{want} (rtol {rtol})")
    # The first step's gradients, tensor by tensor in the L2 norm: against
    # the ranks' function computed here (the same rows, draws and render
    # seeds, summed and halved), and, as what float32 makes of a sum over
    # 4096 cells split in two, the 1-process gradient beside it.
    first = ranks[0]["grads"][0]
    gap_split = {n: norm_gap(g, s) for n, g, s in zip(names, first, split)}
    gap_one = {n: norm_gap(g, o) for n, g, o in zip(names, first, one["grads"][0])}
    floor = {n: norm_gap(s, o) for n, s, o in zip(names, split, one["grads"][0])}
    worst = max(gap_split, key=gap_split.get)
    if not gap_split[worst] <= 1e-5:
        missed.append(f"the first step's reduced gradient of {worst} is {gap_split[worst]:.3g} "
                      f"of its norm from the halves' mean (> 1e-5)")
    # The parameters. After the first step, Adam's rule (atol 1e-5 where
    # |g| >= 1e-5; below, -lr g / (|g| + 1e-7) turns a summation-order
    # difference into an update difference of up to 2 lr, and only the
    # gradient is held, above) against the ranks' function computed here,
    # and beside it the 1-process run. After all the steps, within 2 lr a
    # step of both: an update flipped by the first step moves the later
    # steps' gradients, and the card's convolutions sum in another order
    # from run to run, so even the same function drifts by that much. Each
    # step is held alone in ``hold_each_step``.
    params1 = ranks[0]["params"][0]
    adam_split, adam_split_at = adam_gap(torch, names, params1, split_params1, split)
    adam_one, adam_one_at = adam_gap(torch, names, params1, one["params"][0], one["grads"][0])
    if not adam_split <= 1e-5:
        missed.append(f"{adam_split_at} after the first step differs by {adam_split:.3g} > 1e-5 "
                      f"from the ranks' function computed in one process, where |g| >= 1e-5")
    lr_bound = 2 * 1e-4 * P13_STEPS
    drift = {k: max((pn - pr).abs().max().item() for pn, pr in zip(ranks[0]["params"][-1], ref))
             for k, ref in (("split", split_params), ("one", one["params"][-1]))}
    for k, label in (("split", "the ranks' function computed in one process"),
                     ("one", "the 1-process run")):
        if not drift[k] <= lr_bound:
            missed.append(f"a parameter after {P13_STEPS} steps differs by {drift[k]:.3g} > "
                          f"{lr_bound:.3g} (2 lr a step) from {label}")
    missed += hold_each_step(torch, np, "P13", names, ranks[0], chain, cuda0)
    top = sorted(floor, key=floor.get, reverse=True)[:3]
    log(f"P13 (LG-SPAIR config #5, global B=256, {RANKS} processes on one card, 128 rows each, "
        f"render noise 0.01): losses " + ", ".join(f"{v:.4f}" for v in losses)
        + " (the ranks' mean) against " + ", ".join(f"{v:.4f}" for v in one["losses"])
        + f" in one process; the ranks' parameters "
        + ("bit-equal" if not unequal else f"unequal in {len(unequal)} tensors")
        + f"; after the first step within {adam_split:.3g} ({adam_split_at}) of the ranks' "
        f"function computed in one process where |g| >= 1e-5, {adam_one:.3g} ({adam_one_at}) of "
        f"the 1-process run; after {P13_STEPS} steps within {drift['split']:.3g} and "
        f"{drift['one']:.3g} of the two on every element")
    log(f"P13 first step's reduced gradients, L2 gap of a tensor's norm: to the halves' mean "
        f"at most {gap_split[worst]:.3g} ({worst}); to the 1-process gradient at most "
        f"{max(gap_one.values()):.3g}; the halves' mean to the 1-process gradient (float32's "
        f"split of the sum, no transport): " + ", ".join(f"{n} {floor[n]:.3g}" for n in top))
    for r, res in enumerate(ranks):
        log(f"P13 rank {r}: backend {res['backend']}; launches in {P13_STEPS} steps "
            f"{res['launches']}; peak device memory {res['peak_gib']:.3f} GiB")
    log(f"P13 one process (the reference): peak device memory {one['peak_gib']:.3f} GiB")
    if missed:
        fail("P13: " + "; ".join(missed))
    one["rank_peak_gib"] = ranks[0]["peak_gib"]
    return {k: sum(res["launches"][k] for res in ranks) for k in KERNELS}, one, chain


# The weights the JAX rule shards at config #5 over 2 model ranks
# (split_vae_tpu/parallel/mesh.py:181-188): 31,670,272 of 32,073,267 parameters.
P15_SHARDED = sorted([
    "bg_encoder.Dense_0.weight", "bg_encoder.Dense_1.weight",
    "x_hat_encoder.Dense_0.weight", "x_hat_encoder.Dense_1.weight",
    "bg_decoder.Dense_1.weight", "bg_decoder.Dense_2.weight",
    "x_hat_decoder.Dense_1.weight", "x_hat_decoder.Dense_2.weight",
    "encoder.obj_encoder.Dense_0.weight", "decoder.ObjDecoder_0.Dense_1.weight",
    "encoder.conv2.weight", "encoder.conv3.weight",
])
P15_GRID = (2, 2)  # data x model


def run_p15(torch, np, one, chain):
    """P15: tensor parallelism. P13's configuration, seed and batches (config
    #5, global B=256) in 4 processes on the one card over gloo, a grid of 2
    data x 2 model (128 rows a data index), the JAX rule's 12 weights sharded,
    held against the 2 x 2 function computed in this process (the data
    halves, and the sharded weights by blocks, ``compute_by_blocks``), at
    every step also from the ranks' own state, and against P13's references
    (the same steps in one process, ``one``; the data halves with whole
    weights, ``chain``) at the losses and 2 lr a step; the gaps to those
    logged. Returns the ranks' launches summed."""
    import tempfile

    world = P15_GRID[0] * P15_GRID[1]
    cuda0 = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as out:
        spawn_ranks("p13_rank", world, (out, P15_GRID[1]), timeout=600)
        ranks = [torch.load(os.path.join(out, f"p13_rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    missed = []
    names = one["names"]
    for r, res in enumerate(ranks):
        if res["grid"] != divmod(r, P15_GRID[1]):
            missed.append(f"rank {r} sits at (data, model) {res['grid']}")
        if sorted(res["sharded"]) != P15_SHARDED:
            missed.append(f"rank {r} sharded {res['sharded']}, not the JAX rule's 12 weights")
        if res["notfinite"] or not np.isfinite(res["losses"]).all():
            missed.append(f"rank {r}: losses {res['losses']}, {res['notfinite']} skipped updates")
        for kernel, n in res["launches"].items():
            if n != (0 if kernel.startswith("render_windowed") else P13_STEPS):
                missed.append(f"rank {r} launched {kernel} {n} times in {P13_STEPS} steps")
    unequal = []
    for m in range(P15_GRID[1]):  # the ranks of one model index: bit-equal blocks
        group = ranks[m::P15_GRID[1]]
        unequal += [f"{name} (model index {m})" for name, *blocks in
                    zip(names, *(res["blocks"] for res in group))
                    if not all(torch.equal(blocks[0], b) for b in blocks[1:])]
    if unequal:
        missed.append(f"the ranks of a model index differ after the steps: {unequal[:5]}")
    # The replicated leaves: bit-equal on every rank (their gradients' mean
    # over the world, train/steps.py's reduce_gradients_).
    apart = [n for i, n in enumerate(names) if n not in P15_SHARDED
             and not all(torch.equal(ranks[0]["blocks"][i], res["blocks"][i]) for res in ranks)]
    if apart:
        missed.append(f"the ranks' replicated leaves differ after the steps: {apart[:5]}")
    data_losses = [ranks[d * P15_GRID[1]]["losses"] for d in range(P15_GRID[0])]
    losses = [sum(ls[i] for ls in data_losses) / P15_GRID[0] for i in range(P13_STEPS)]
    for i, (got, want) in enumerate(zip(losses, one["losses"])):
        rtol = 1e-5 if i == 0 else 1e-4
        if not abs(got - want) <= rtol * abs(want):
            missed.append(f"step {i + 1}'s loss, the data indices' mean {got}, is not the "
                          f"1-process {want} (rtol {rtol})")
    # The references: the 2 x 2 ranks' function computed in this process (the
    # data halves as P13's chain, the sharded weights by blocks: a block's
    # product sums in the order the rank's does), held at P13's tolerances;
    # beside it P13's chain (the data halves, whole weights) and the
    # 1-process run, whose products over whole weights sum in another order.
    rec = ranks[0]
    grid_chain = p13_emulated(torch, np, cuda0, blocks=P15_SHARDED)
    gaps = {n: norm_gap(g, e) for n, g, e in zip(names, rec["grads"][0], grid_chain["grads"][0])}
    worst = max(gaps, key=gaps.get)
    if not gaps[worst] <= 1e-5:
        missed.append(f"the first step's gathered gradient of {worst} lies {gaps[worst]:.3g} of "
                      f"its norm from the 2 x 2 function computed here (> 1e-5)")
    beside = {key: max(norm_gap(g, e) for g, e in zip(rec["grads"][0], ref["grads"][0]))
              for key, ref in (("whole", chain), ("one", one))}
    adam = {key: adam_gap(torch, names, rec["params"][0], ref["params"][0], ref["grads"][0])
            for key, ref in (("grid", grid_chain), ("whole", chain), ("one", one))}
    if not adam["grid"][0] <= 1e-5:
        missed.append(f"{adam['grid'][1]} after the first step differs by {adam['grid'][0]:.3g} "
                      f"> 1e-5 from the 2 x 2 function computed here, where |g| >= 1e-5")
    lr_bound = 2 * 1e-4 * P13_STEPS
    drift = {k: max((pn - pr).abs().max().item() for pn, pr in zip(rec["params"][-1], ref))
             for k, ref in (("grid", grid_chain["params"][-1]), ("whole", chain["params"][-1]),
                            ("one", one["params"][-1]))}
    for k, v in drift.items():
        if not v <= lr_bound:
            missed.append(f"a parameter after {P13_STEPS} steps differs by {v:.3g} > "
                          f"{lr_bound:.3g} (2 lr a step) from {k}")
    missed += hold_each_step(torch, np, "P15", names, rec, grid_chain, cuda0, blocks=P15_SHARDED)
    card = card_line()
    log(f"P15 (LG-SPAIR config #5, global B=256, {P15_GRID[0]} data x {P15_GRID[1]} model in "
        f"{world} processes on one card over gloo, 128 rows a data index, render noise 0.01; "
        f"{card}): {len(rec['sharded'])} weights sharded, {rec['params_a_rank']:,} parameters a "
        f"rank of {sum(p.numel() for p in one['params'][0]):,}; losses "
        + ", ".join(f"{v:.4f}" for v in losses) + " (the data indices' mean) against "
        + ", ".join(f"{v:.4f}" for v in one["losses"]) + " in one process; the ranks of a model "
        "index " + ("bit-equal" if not unequal else f"unequal in {len(unequal)} tensors")
        + "; the replicated leaves " + ("bit-equal on every rank" if not apart else
                                        f"unequal in {len(apart)} tensors") + "; the first "
        f"step's gathered gradients within {gaps[worst]:.3g} of a norm ({worst}) of the 2 x 2 "
        f"function computed in one process (held), {beside['whole']:.3g} of the data halves' "
        f"with whole weights and {beside['one']:.3g} of the 1-process run's; after the first "
        f"step, where |g| >= 1e-5, within {adam['grid'][0]:.3g} ({adam['grid'][1]}) of the 2 x 2 "
        f"function (held), {adam['whole'][0]:.3g} ({adam['whole'][1]}) of the data halves' and "
        f"{adam['one'][0]:.3g} ({adam['one'][1]}) of the 1-process run; after {P13_STEPS} steps "
        f"within {drift['grid']:.3g}, {drift['whole']:.3g} and {drift['one']:.3g} of the three on "
        "every element")
    for r, res in enumerate(ranks):
        log(f"P15 rank {r} (data {res['grid'][0]}, model {res['grid'][1]}): peak device memory "
            f"{res['peak_gib']:.3f} GiB (a P13 rank: {one['rank_peak_gib']:.3f} GiB); launches "
            f"{res['launches']}")
    if missed:
        fail("P15: " + "; ".join(missed))
    return {k: sum(res["launches"][k] for res in ranks) for k in KERNELS}


P15_CLI_STEPS = 20


def p15_cli_rank(rank, world, port, tmp, out):
    """A process of P15's CLI run: spair_main at config #5's flags with
    --num_model_shards 2 on NCCL, one card a process."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from split_vae_torch.cli import spair_main

    torch.cuda.set_device(rank)
    os.chdir(tmp)
    spair_main.main(CONFIG5_ARGV + [
        "-synthetic_data", "--batch_size", "256", "--training_steps", str(P15_CLI_STEPS),
        "--eval_interval", str(P15_CLI_STEPS), "--checkpoint_interval", str(P15_CLI_STEPS),
        "--log_every", "10", "--num_model_shards", "2", "--data_dir", tmp,
        "--output_dir", os.path.join(tmp, "output"), "--coordinator", f"127.0.0.1:{port}",
        "--num_processes", str(world), "--process_id", str(rank)])
    torch.save({"backend": dist.get_backend(), "peak_gib": torch.cuda.max_memory_allocated() / 2**30},
               os.path.join(out, f"p15_cli_rank{rank}.pt"))
    dist.destroy_process_group()


def run_p15_cli(torch, np):
    """spair_main with --num_model_shards 2 over NCCL on 2 cards, where the
    machine has them; else a line that says where the CLI's tensor
    parallelism is held."""
    import tempfile

    if torch.cuda.device_count() < 2:
        log("P15 CLI: one card, so spair_main --num_model_shards 2 over NCCL does not run here; "
            "the CLI's tensor parallelism is held by the CPU tests "
            "(tests/test_torch_tensor_parallel.py: vae_main in 2 gloo processes)")
        return
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        spawn_ranks("p15_cli_rank", 2, (tmp, tmp), timeout=900)
        ranks = [torch.load(os.path.join(tmp, f"p15_cli_rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        (run,) = os.listdir(os.path.join(tmp, "output"))
        records = check_cli_run(np, "P15 CLI", tmp, run, [P15_CLI_STEPS],
                                ("train/", "test0/", "test1/"))
    if any(res["backend"] != "nccl" for res in ranks):
        fail(f"P15 CLI: backends {[res['backend'] for res in ranks]}")
    (train,) = [r for r in records if "train/total_loss" in r]
    log(f"P15 CLI (spair_main, config #5, --num_model_shards 2, NCCL on 2 cards; "
        f"{card_line()}): train/total_loss {train['train/total_loss']:.4f} at step "
        f"{P15_CLI_STEPS}; peak device memory "
        + ", ".join(f"{res['peak_gib']:.3f}" for res in ranks) + " GiB")


P14_STEPS = 20


def p14_rank(rank, world, port, tmp, out):
    """A P14 process: vae_main at config #2's flags through --coordinator,
    --num_processes and --process_id on NCCL, P14_STEPS steps with one eval
    and one checkpoint, the calls of the gradients' all-reduce
    (``train/steps.py::reduce_gradients_``) counted; with one process (a
    1-process NCCL group, where the step does no collective), the flat
    all-reduce on the card afterwards, on tensors of the model's parameter
    shapes. Saves the results."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from split_vae_torch.cli import vae_main
    from split_vae_torch.core.config import CONFIG2_IMAGE_HW, config2
    from split_vae_torch.parallel.mesh import flat_all_reduce_mean_
    from split_vae_torch.train import steps as steps_mod
    from split_vae_torch.train.loop import build_vae_model

    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    os.chdir(tmp)
    reduce, reduces = steps_mod.reduce_gradients_, []

    def counted(*args, **kwargs):
        reduces.append(1)
        return reduce(*args, **kwargs)

    steps_mod.reduce_gradients_ = counted
    reset_launches()
    try:
        vae_main.main(CONFIG2_ARGV + [
            "-synthetic_data", "--training_steps", str(P14_STEPS), "--eval_interval",
            str(P14_STEPS), "--checkpoint_interval", str(P14_STEPS), "--log_every", "10",
            "--data_dir", tmp, "--output_dir", os.path.join(tmp, "output"),
            "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(world),
            "--process_id", str(rank)])
    finally:
        steps_mod.reduce_gradients_ = reduce
    launches = read_launches()
    explicit = None
    if world == 1:
        model, _ = build_vae_model(config2(), CONFIG2_IMAGE_HW, device=device)
        tensors = [p.detach().clone() for p in model.parameters()]
        want = [t.clone() for t in tensors]
        flat_all_reduce_mean_(tensors, 1)
        explicit = {"equal": all(torch.equal(a, b) for a, b in zip(tensors, want)),
                    "mb": sum(t.numel() for t in tensors) * 4 / 1e6}
    result = {"backend": dist.get_backend(), "world": dist.get_world_size(),
              "launches": launches, "reduces": len(reduces), "explicit": explicit,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "device": torch.cuda.get_device_name(device)}
    torch.save(result, os.path.join(out, f"p14_rank{rank}.pt"))
    dist.destroy_process_group()


def run_p14(torch, np):
    """P14: vae_main at config #2 on NCCL: 2 processes on 2 cards where the
    machine has them, else a 1-process NCCL group on the one card with the
    flat all-reduce run on it; logs which of the two ran. Returns the
    launches (all 0: no SPAIR kernel lies on the VAE path)."""
    import tempfile

    world = 2 if torch.cuda.device_count() >= 2 else 1
    which = (f"{world} processes over NCCL on {world} cards" if world > 1 else
             "one process in a 1-process NCCL group on the one card, then the flat all-reduce")
    log(f"P14 (vae_main, config #2, {P14_STEPS} steps): {which}")
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        spawn_ranks("p14_rank", world, (tmp, tmp), timeout=600)
        ranks = [torch.load(os.path.join(tmp, f"p14_rank{r}.pt"), weights_only=False)
                 for r in range(world)]
        (run,) = os.listdir(os.path.join(tmp, "output"))
        records = check_cli_run(np, "P14", tmp, run, [P14_STEPS], ("train/", "test/"))
    for r, res in enumerate(ranks):
        if res["backend"] != "nccl" or res["world"] != world:
            fail(f"P14: rank {r} ran {res['backend']} in a world of {res['world']}")
        if any(res["launches"].values()):
            fail(f"P14: a SPAIR kernel was launched on the VAE path: {res['launches']}")
        steps = P14_STEPS + 1
        if world > 1 and res["reduces"] != steps:
            fail(f"P14: rank {r} reduced {res['reduces']} times in {steps} steps")
        reduce = ("one all-reduce a step" if world > 1 else
                  "no collective in the step (a 1-rank mesh)")
        log(f"P14 rank {r} on {res['device']}: {res['backend']}, {reduce}; peak device memory "
            f"{res['peak_gib']:.3f} GiB")
    explicit = ranks[0]["explicit"]
    if explicit is not None:
        if not explicit["equal"]:
            fail("P14: the flat all-reduce over a 1-process NCCL group changed the tensors")
        log(f"P14: flat all-reduce of config #2's {explicit['mb']:.2f} MB of parameters over "
            f"NCCL on the card left them as they were")
    (train,) = [r for r in records if "train/total_loss" in r]
    log(f"P14: train/total_loss {train['train/total_loss']:.4f} at step {P14_STEPS}")
    return {k: sum(res["launches"][k] for res in ranks) for k in KERNELS}


def main() -> None:
    parser = argparse.ArgumentParser(description="Checks of the port on one NVIDIA GPU.")
    parser.add_argument("--parent", default=None,
                        help="another checkout: also hold the full-canvas render at C = 1 and 3 "
                             "bit-equal to the kernel built from its csrc/render.cu")
    parent = parser.parse_args().parent
    if not os.path.isdir(os.path.join(HERE, "split_vae_torch")):
        fail("split_vae_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from split_vae_torch.core.config import (
        CONFIG2_IMAGE_HW,
        CONFIG3_IMAGE_HW,
        SpairConfig,
        config2,
        config3,
        config5,
        config_bg_spair,
        config_glimpse_spair,
    )
    from split_vae_torch.kernels import build, crop, render
    from split_vae_torch.kernels import render_windowed as windowed
    from split_vae_torch.train.steps import use_fp32

    # Phase 1: the card.
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_fp32()

    # Phase 2: build, one compiler a source.
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: nvcc sm_90a in {time.perf_counter() - t0:.1f} s -> "
        + ", ".join(os.path.relpath(lib, HERE) for lib in libs.values()))
    for lib in libs.values():
        with open(lib[:-3] + ".log") as f:
            entry = ""
            for line in f:
                if "Compiling entry function" in line:
                    entry = line.split("'")[1]
                elif "registers" in line or "spill" in line:
                    log(f"  ptxas: {entry}: {line.strip()}")

    # Phase 3: kernels against their plain versions.
    # Render shapes: B, grid, object size, canvas, colour channels.
    cfg5_shape, p3_shape, ragged_shape = (256, 4, 32, 48, 3), (256, 4, 28, 48, 3), (8, 4, 30, 45, 3)
    log("kernel vs plain (fp32, TF32 off):")
    errs = dict.fromkeys(KERNELS, 0.0)

    def keep(kernel, fwd_err, bwd_err):
        errs[kernel + "_fwd"] = max(errs[kernel + "_fwd"], fwd_err)
        errs[kernel + "_bwd"] = max(errs[kernel + "_bwd"], bwd_err)

    render_cases = ((cfg5_shape, 0.0), (cfg5_shape, 0.01), (ragged_shape, 0.0),
                    (ragged_shape, 0.01), (p3_shape, 0.01))
    for i, (shape, noise) in enumerate(render_cases):
        keep("render", *compare_kernels(torch, render, shape, noise, seed=i + 1))
    keep("render", *compare_kernels(torch, render, cfg5_shape, 0.01, seed=6, z_scale=10.0))
    # Other channel counts: C = 1 and 3 have instances of their own, 2 and 4
    # take the general one.
    other_c = [ragged_shape[:4] + (c,) for c in (1, 2, 4)]
    for i, shape in enumerate(other_c):
        keep("render", *compare_kernels(torch, render, shape, 0.01, seed=7 + i))
    for i, (shape, noise) in enumerate(render_cases + ((p3_shape, 0.0),)):
        keep("render_windowed", *compare_kernels(torch, render, shape, noise, seed=i + 1,
                                                 windowed=windowed))
    keep("render_windowed", *compare_kernels(torch, render, cfg5_shape, 0.01, seed=6,
                                             z_scale=10.0, windowed=windowed))
    for i, shape in enumerate(other_c):
        keep("render_windowed", *compare_kernels(torch, render, shape, 0.01, seed=7 + i,
                                                 windowed=windowed))
    # A 66-row canvas: find_band takes three ballots of 32 rows.
    keep("render_windowed", *compare_kernels(torch, render, (8, 4, 44, 66, 3), 0.01, seed=10,
                                             windowed=windowed))
    if parent is not None:
        compare_with_parent(torch, render, parent)
    # The CPU path draws the same noise field with a numpy twin of the kernels'
    # Philox; the two agree up to the float32 math libraries (log, cos, sqrt).
    seed_t = torch.tensor([12345], dtype=torch.int32, device="cuda")
    noise_err = (render.render_noise(seed_t, 2, 16, 3, 45, 45).cpu()
                 - render.render_noise(seed_t.cpu(), 2, 16, 3, 45, 45)).abs().max().item()
    if not noise_err <= 1e-5:
        fail(f"render noise: card field vs the CPU's numpy twin, max err {noise_err:.3g} > 1e-5")
    log(f"  render noise: card field vs the CPU's numpy twin, max err {noise_err:.3g}")
    # Crop shapes: B, grid, canvas, glimpse size, channels.
    crop_p1, crop_p3 = (256, 4, 48, 32, 3), (256, 4, 48, 28, 3)
    for i, shape in enumerate((crop_p1, crop_p3, (8, 4, 48, 32, 6), (8, 3, 45, 30, 3))):
        keep("crop", *compare_crop(torch, crop, shape, seed=i + 1))
    keep("crop", *compare_crop(torch, crop, crop_p1, seed=5, z_scale=10.0))

    # Phase 4: times, with the main paths' render noise 0.01.
    times, bound, chain_ms = {}, {}, {}
    for label, shape in (("P1/P2", cfg5_shape), ("P3", p3_shape)):
        t = time_render(torch, render, shape, 0.01)
        bd, objs_read = bounds(shape, *t["coords"], 0.01)
        log(f"render bounds at {label}: objs read {objs_read / 1e6:.2f} MB of "
            f"{4 * shape[0] * shape[1] ** 2 * shape[2] ** 2 * (shape[4] + 1) / 1e6:.2f} "
            f"(32-byte sectors of the in-object taps)")
        for name in ("fwd", "bwd"):
            tb, by, nbytes, flops, term = bd[name]
            log(f"render {name} at {label} {shape}: kernel {t[name]:.4f} ms ({tb / t[name]:.3f} of "
                f"the bound), plain {t['plain_' + name]:.4f} ms, bound {tb:.4f} ms by {term} "
                f"(bytes {nbytes / 1e6:.1f} MB = {nbytes / PEAK_BYTES * 1e3:.4f} ms, "
                f"{flops / 1e9:.3f} GFLOP = {flops / PEAK_FP32 * 1e3:.4f} ms)")
        log(f"render_noise at {label}: {t['noise']:.4f} ms for the call's "
            f"{shape[0] * shape[1] ** 2 * shape[4] * shape[3] ** 2 / 1e6:.2f} M normals")
        log(f"render rows a block (forward ms; the wrapper takes {render.ROWS_PER_BLOCK}): "
            + ", ".join(f"{n}: {v:.4f}" for n, v in t["sweep_fwd"].items()))
        log(f"render cells a block (backward ms; the wrapper takes {render.CELLS_PER_BLOCK}): "
            + ", ".join(f"{n}: {v:.4f}" for n, v in t["sweep_bwd"].items()))
        if label == "P1/P2":
            for name in ("fwd", "bwd"):
                times["render_" + name] = (t[name], t["plain_" + name], None)
                bound["render_" + name] = bd[name]
    for label, shape in (("P4", cfg5_shape), ("28 on 48", p3_shape)):
        t = time_windowed(torch, render, windowed, shape, 0.01)
        bd, objs_read = windowed_bounds(shape, *t["coords"], 0.01, t["band_rows"])
        cells = shape[0] * shape[1] ** 2
        log(f"windowed render at {label} {shape}: bands of {t['band_rows'] / cells:.2f} rows a "
            f"cell of {shape[3]}; objs read {objs_read / 1e6:.2f} MB")
        for name in ("fwd", "bwd"):
            tb, by, nbytes, flops, term = bd[name]
            log(f"windowed render {name} at {label}: kernel {t[name]:.4f} ms ({tb / t[name]:.3f} "
                f"of the bound; turns " + ", ".join(f"{v:.4f}" for v in t["turns"][name])
                + f"), {t[name] / t['full_' + name]:.3f} of the full-canvas kernel's "
                f"{t['full_' + name]:.4f} ms in the same turns (" + ", ".join(
                    f"{v:.4f}" for v in t["turns"]["full_" + name])
                + f"), plain {t['plain_' + name]:.4f} ms, bound {tb:.4f} ms by {term} (bytes "
                f"{nbytes / 1e6:.1f} MB = {nbytes / PEAK_BYTES * 1e3:.4f} ms, {flops / 1e9:.3f} "
                f"GFLOP = {flops / PEAK_FP32 * 1e3:.4f} ms)")
        log(f"windowed rows a block (forward ms; the wrapper takes {windowed.ROWS_PER_BLOCK}): "
            + ", ".join(f"{n}: {v:.4f}" for n, v in t["sweep_fwd"].items()))
        log(f"windowed cells a block (backward ms; the wrapper takes "
            f"{windowed.CELLS_PER_BLOCK}): "
            + ", ".join(f"{n}: {v:.4f}" for n, v in t["sweep_bwd"].items()))
        if label == "P4":
            for name in ("fwd", "bwd"):
                times["render_windowed_" + name] = (t[name], t["plain_" + name], None)
                bound["render_windowed_" + name] = bd[name]
    for label, shape in (("P1/P2", crop_p1), ("P3", crop_p3)):
        t = time_crop(torch, crop, shape)
        bd = crop_bounds(shape)
        for name in ("fwd", "bwd", "bwd_all"):
            tb, by, nbytes, flops, _ = bd[name]
            log(f"crop {name} at {label} {shape}: kernel {t[name]:.4f} ms ({tb / t[name]:.3f} "
                f"of the bound), plain {t['plain_' + name]:.4f} ms, library (einsum on prebuilt "
                f"weights) {t['library_' + name]:.4f} ms, library chain (interp_matrix x2 + "
                f"einsum) {t['chain_' + name]:.4f} ms, bound {tb:.4f} ms by {by} "
                f"({nbytes / 1e6:.3f} MB, {flops / 1e9:.3f} GFLOP)")
        log(f"crop cells a block at {label} (forward / backward ms; the wrapper takes "
            f"{crop.CELLS_PER_BLOCK_FWD} / {crop.CELLS_PER_BLOCK_BWD}): " + ", ".join(
                f"{n}: {f:.4f} / {b:.4f}" for n, (f, b) in t["sweep"].items()))
        if label == "P1/P2":
            for name in ("fwd", "bwd"):  # "bwd": without g_img, as the paths call it
                times["crop_" + name] = (t[name], t["plain_" + name], t["library_" + name])
                chain_ms["crop_" + name] = t["chain_" + name]
                bound["crop_" + name] = bd[name]

    # The fused optimizer at config #5's and config #2's leaves; the count prior.
    adam_row = run_adam(torch, np)
    count_prior_row = run_count_prior(torch, np)

    # Phase 5: small steps against the CPU, then the main paths.
    small = dict(batch_size=4, latent_size=8, bg_latent_size=8, local_latent_size=8,
                 image_size=(24, 24, 3))
    small_step_check(torch, np, config5(**small, object_size=16), "LG-SPAIR")
    small_step_check(torch, np, config5(**small, object_size=16), "LG-SPAIR, windowed render",
                     windowed=True)
    small_step_check(torch, np, SpairConfig(**small, model="bg_spair", object_size=16),
                     "BG-SPAIR")
    small_step_check(torch, np, SpairConfig(**small, model="lg_glimpse_spair", object_size=12,
                                            patch_size=4), "LGGlimpseSPAIR")
    small_vae_step_check(torch, np, config2(batch_size=4, global_latent_dims=8,
                                            local_latent_dims=8), (32, 32), "LGVae")
    for kind, label in (("lggmvae", "LGGMVae"), ("gmvae", "GMVae")):
        small_vae_step_check(torch, np, config3(model=kind, batch_size=4, global_latent_dims=8,
                                                local_latent_dims=8, y_size=5), (32, 32), label,
                             grad_dtype=torch.float64)
    # P16: the chained forms, the card's optimizer state against the CPU's.
    chained_spair_check(torch, np, config5(**small, object_size=16), "LG-SPAIR")
    chained_spair_check(torch, np, config5(**small, object_size=16),
                        "LG-SPAIR, windowed render", windowed=True)
    # From step 0 and a fresh Adam state: the bias correction, the anneals' starts.
    chained_spair_check(torch, np, config5(**small, object_size=16), "LG-SPAIR from step 0",
                        start=0)
    chained_gm_check(torch, np, config3(batch_size=4, global_latent_dims=8, local_latent_dims=8,
                                        y_size=5), (32, 32), "LGGMVae")
    launches, losses = {}, {}
    for name, cfg, windowed_render in (("P1", config5(), False), ("P2", config_bg_spair(), False),
                                       ("P3", config_glimpse_spair(), False),
                                       ("P4", config5(), True)):
        launches[name], losses[name] = run_path(torch, np, name, cfg, windowed_render)
        torch.cuda.empty_cache()
    # P4 is P1 with the other render pair: the same model, batches and draws,
    # the render seeds included. The first loss differs by the two kernels'
    # forward difference only; later ones also by what Adam makes of it.
    log("P1 losses: " + ", ".join(f"{v:.4f}" for v in losses["P1"]))
    log("P4 losses: " + ", ".join(f"{v:.4f}" for v in losses["P4"]))
    first = abs(losses["P4"][0] - losses["P1"][0]) / abs(losses["P1"][0])
    if not first <= 1e-5:
        fail(f"P4's first loss {losses['P4'][0]} is not P1's {losses['P1'][0]} (rtol 1e-5)")
    log(f"P4 vs P1: first loss within {first:.3g} relative, last within "
        f"{abs(losses['P4'][-1] - losses['P1'][-1]) / abs(losses['P1'][-1]):.3g}")
    launches["P5"], losses["P5"] = run_vae_path(
        torch, np, "P5", config2(), CONFIG2_IMAGE_HW)
    torch.cuda.empty_cache()
    # bfloat16: config #5 and config #2 again, every Dense and Conv in bfloat16,
    # the same seeds and batches; the first loss within rtol 0.02 of the
    # float32 path's (the JAX package's own contract, tests/test_bf16_mode.py).
    launches["P10"], losses["P10"] = run_path(
        torch, np, "P10", config5(compute_dtype="bfloat16"))
    torch.cuda.empty_cache()
    launches["P11"], losses["P11"] = run_vae_path(
        torch, np, "P11", config2(compute_dtype="bfloat16"), CONFIG2_IMAGE_HW)
    torch.cuda.empty_cache()
    for bf16, f32 in (("P10", "P1"), ("P11", "P5")):
        first = abs(losses[bf16][0] - losses[f32][0]) / abs(losses[f32][0])
        if not first <= 0.02:
            fail(f"{bf16}'s first loss {losses[bf16][0]} is not within rtol 0.02 of {f32}'s "
                 f"{losses[f32][0]}")
        log(f"{bf16} (bfloat16) vs {f32} (float32): first loss within {first:.3g} relative")
    # The resize2x -> conv fusion: its forms against the chain at every site.
    resize_conv_sites(torch)
    # The CLIs: config #5 and config #2 trained, checkpointed and resumed.
    from split_vae_torch.cli import spair_main, vae_main

    cli_args = ["-synthetic_data", "--eval_interval", "20", "--checkpoint_interval", "20",
                "--log_every", "10"]
    launches["P6"], _ = run_cli_path(
        torch, np, "P6", spair_main.main, CONFIG5_ARGV + cli_args + ["--batch_size", "256"],
        ("test0/", "test1/"), pngs=spair_pngs((48, 48), 4, 32, 2, 256, "lg_spair"))
    torch.cuda.empty_cache()
    p7_pngs = vae_pngs(CONFIG2_IMAGE_HW, "lgvae", svhn=False, viz=False, last_batch=64, y_size=0)
    launches["P7"], _ = run_cli_path(
        torch, np, "P7", vae_main.main, CONFIG2_ARGV + cli_args, ("test/",), pngs=p7_pngs)
    torch.cuda.empty_cache()
    launches["P12"], _ = run_cli_path(
        torch, np, "P12", vae_main.main,
        CONFIG2_ARGV + cli_args + ["--compute_dtype", "bfloat16"], ("test/",), first=20,
        resumed=None, pngs=p7_pngs)
    torch.cuda.empty_cache()
    # Config #3: LGGMVae at full width, then through the CLIs with the probe.
    launches["P8"], losses["P8"] = run_vae_path(
        torch, np, "P8", config3(), CONFIG3_IMAGE_HW)
    torch.cuda.empty_cache()
    from split_vae_torch.cli import vae_main as vae_cli

    launches["P9"] = run_classifier_cli(torch, np)

    def committed_classifier(tmp):
        os.makedirs(os.path.join(tmp, "models"))
        shutil.copy(os.path.join(HERE, "models", DIGITS_CLASSIFIER),
                    os.path.join(tmp, "models", DIGITS_CLASSIFIER))

    p9, records = run_cli_path(
        torch, np, "P9", vae_cli.main, CONFIG3_ARGV + cli_args + ["-viz"], ("test/",),
        prepare=committed_classifier,
        pngs=vae_pngs(CONFIG3_IMAGE_HW, "lggmvae", svhn=True, viz=True, last_batch=64,
                      y_size=30))
    check_probe_records("P9", records, PROBE_KEYS)
    p9_gm, records = run_cli_path(
        torch, np, "P9 gmvae", vae_cli.main,
        CONFIG3_ARGV + cli_args + ["--model", "gmvae", "-viz"], ("test/",), first=20,
        resumed=None, prepare=committed_classifier,
        pngs=vae_pngs(CONFIG3_IMAGE_HW, "gmvae", svhn=True, viz=True, last_batch=64, y_size=30))
    check_probe_records("P9 gmvae", records, ())
    launches["P9"] = {k: launches["P9"][k] + p9[k] + p9_gm[k] for k in KERNELS}
    torch.cuda.empty_cache()
    # Config #4: SPLIT-GMVAE at 64x64 through vae_main with the README's flags.
    launches["P17"] = run_p17(torch, np, cli_args)
    torch.cuda.empty_cache()
    # Data parallelism: config #5 in 2 processes on the card, config #2 on NCCL;
    # tensor parallelism: config #5 in a 2 x 2 grid on the card, held to P13's
    # references.
    launches["P13"], one, chain = run_p13(torch, np)
    torch.cuda.empty_cache()
    launches["P15"] = run_p15(torch, np, one, chain)
    del one, chain
    torch.cuda.empty_cache()
    launches["P14"] = run_p14(torch, np)
    run_p15_cli(torch, np)

    # Phase 6: the record.
    pallas, research = "split_vae_tpu/ops/pallas/", "tools/pallas_research/"
    replaces = {
        "render_fwd": f"{pallas}render_packed.py:87; {pallas}render_fused.py:89",
        "render_bwd": f"{pallas}render_packed.py:124; {pallas}render_fused.py:119",
        "crop_fwd": f"{research}crop_packed.py:64; {research}crop_fused.py:33",
        "crop_bwd": f"{research}crop_packed.py:80; {research}crop_fused.py:42",
        "render_windowed_fwd": f"{research}render_windowed.py:97",
        "render_windowed_bwd": f"{research}render_windowed.py:149",
    }
    kernels = []
    for name in KERNELS:
        ms, plain_ms, library_ms = times[name]
        t, by, _, _, term = bound[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"split_vae_torch/csrc/{name.rsplit('_', 1)[0]}.cu",
            "replaces": replaces[name],
            "launches": sum(path[name] for path in launches.values()),
            "launches_by_path": {path: counts[name] for path, counts in launches.items()},
            "max_abs_err": errs[name], "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": t, "bound_by": by, "bound_term": term, "library_ms": library_ms,
            "library_chain_ms": chain_ms.get(name),
        })
    adam_row.update(launches=sum(FUSED_BY_PATH.values()), launches_by_path=dict(FUSED_BY_PATH))
    kernels.append(adam_row)
    count_prior_row.update(launches_by_path=dict(COUNT_PRIOR_BY_PATH))
    kernels.append(count_prior_row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
