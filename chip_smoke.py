"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width (random weights from a seed):
SPAIR-family train steps (B=256, 48-px canvases, 4x4 cells) through the
hand-written CUDA kernels (the fused paste+composite render, full-canvas and
row-windowed, and the STN glimpse crop), and the LGVae train step, which has
no hand-written kernel on it. The paths:

  P1  LG-SPAIR at BASELINE config #5 (Multi-Bird-Hard: 32-px objects, dense
      background and local paths);
  P2  BG-SPAIR at the SpairConfig defaults (32-px objects);
  P3  LGGlimpseSPAIR with 28-px objects in 4-px patches, the shapes that are
      not multiples of 8;
  P4  P1's configuration, model and seed with the row-windowed render
      selected in place of the full-canvas one;
  P5  LGVae (SPLIT-VAE) at BASELINE config #2 (CelebA 64x64, B=64, patch 8,
      latents 128/128), uint8 batches.

Phases, each of which must pass:

  1. the card's name and power limit, from nvidia-smi;
  2. build the kernels from split_vae_torch/csrc (one nvcc a source, side by
     side, sm_90a), timed;
  3. each kernel against its plain PyTorch version on the card (TF32 off).
     Render: at the config-#5 shapes and at an unaligned shape (30-px objects
     on 45-px canvases), with render noise 0 and 0.01. Windowed render: the
     same shapes and noise levels and 28-px objects on 48 px, also against the
     full-canvas kernel on the same inputs and seed (forward atol 3e-6) and
     with g_wy exactly zero outside the bands. Crop (over the sample
     coordinates ys, xs): at 48 -> 32 px and 48 -> 28 px (B=256), with 6
     channels, at a ragged shape (9 cells, 45 -> 30 px) and at 48 -> 32 px
     with z_where x10 (saturated boxes, coordinates outside the image); the
     gradients of img, ys and xs, and the two the model's path asks for; two
     runs of each kernel bit-equal. Forward atol 3e-5, gradients rtol 1e-3,
     atol 2e-4: the limits the JAX package's tests hold its Pallas kernels
     to (fp32 sums in another order);
  4. kernel, plain and, for the crop, two library times (the one-call einsum
     on prebuilt weights; interp_matrix twice and that einsum) and a sweep of
     its cells a block, at the shapes of P1/P2/P4 and of P3 (median of
     CUDA-event timings), and bounds; the windowed pair in turns with the
     full-canvas pair;
  5. one small train step on the card against the same step on the CPU (plain
     kernels' versions) for LG-SPAIR (full-canvas and windowed render),
     BG-SPAIR, LGGlimpseSPAIR and LGVae, then each main path: train steps with
     the kernels' launch counts set to 0 before and read after, a profile of
     three more steps (device time by kernel family, the device's idle share),
     and one eval step; P4's losses beside P1's;
  6. one JSON line of the kernels, then the card, then {"ok": true, ...}.

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
WINDOWED_VS_FULL_ATOL = 3e-6
GRAD_RTOL, GRAD_ATOL = 1e-3, 2e-4
TRAIN_STEPS, WARMUP_STEPS = 6, 2
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


def render_inputs(torch, b, grid, os_, canvas, c, seed):
    """Config-#5-like render inputs on the card: weights from random boxes.
    Returns the six float inputs, the seed tensor and the rows' sample
    coordinates ys [B,K,H] (which the windowed render reads)."""
    from split_vae_torch.ops.stn import paste_interp_weights_ys

    g = torch.Generator(device="cuda").manual_seed(seed)
    k = grid * grid
    objs = torch.rand((b, k, os_, os_, c + 1), generator=g, device="cuda")
    z_where = torch.randn((b, grid, grid, 4), generator=g, device="cuda")
    wy, wx, _, ys = paste_interp_weights_ys(z_where, (canvas, canvas), (os_, os_))
    z_pres = torch.rand((b, k), generator=g, device="cuda")
    depth_w = torch.sigmoid(-torch.randn((b, k), generator=g, device="cuda")) + 0.5
    bg = torch.rand((b, canvas, canvas, c), generator=g, device="cuda")
    seed_t = torch.tensor([seed * 7919 + 1], dtype=torch.int32, device="cuda")
    return [objs, wy.contiguous(), wx.contiguous(), z_pres, depth_w, bg], seed_t, ys


RENDER_INPUT_NAMES = ("objs", "wy", "wx", "z_pres", "depth_w", "bg")


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
    for name, a, p in zip(RENDER_INPUT_NAMES, g_k, g_p):
        err = (a - p).abs()
        excess = (err - (GRAD_ATOL + GRAD_RTOL * p.abs())).max().item()
        if not excess <= 0:
            fail(f"{what}: backward d{name} max err {err.max().item():.3g} "
                 f"beyond rtol {GRAD_RTOL}, atol {GRAD_ATOL}")
        bwd_err = max(bwd_err, err.max().item())
    return fwd_err, bwd_err, g_k


def compare_kernels(torch, render, shape, noise_scale, seed):
    """Kernel vs plain, forward and the six gradients; returns (fwd err, bwd err)."""
    b, grid, os_, canvas, c = shape
    args, seed_t, _ = render_inputs(torch, b, grid, os_, canvas, c, seed)
    noise = None
    if noise_scale > 0:
        noise = noise_scale * render.render_noise(seed_t, b, grid * grid, c, canvas, canvas)
    ins_k = [a.clone().requires_grad_(True) for a in args]
    ins_p = [a.clone().requires_grad_(True) for a in args]
    out_k = render.fused_paste_render(*ins_k, seed_t, noise_scale)
    out_p = render.render_reference(*ins_p, noise)
    what = f"{shape} noise {noise_scale}"
    fwd_err, bwd_err, _ = hold_to_plain(torch, f"render {what}", out_k, out_p, ins_k, ins_p, seed)
    log(f"  {what}: forward max err {fwd_err:.3g}, gradients max err {bwd_err:.3g}")
    return fwd_err, bwd_err


def compare_windowed(torch, render, windowed, shape, noise_scale, seed):
    """Windowed kernel vs its plain version (forward, six gradients), vs the
    full-canvas kernel on the same inputs and seed (forward atol
    WINDOWED_VS_FULL_ATOL), and g_wy exactly zero outside the bands; returns
    (fwd err, bwd err)."""
    b, grid, os_, canvas, c = shape
    args, seed_t, ys = render_inputs(torch, b, grid, os_, canvas, c, seed)
    bands = windowed.compute_bands(ys, os_)
    noise = None
    if noise_scale > 0:
        noise = noise_scale * render.render_noise(seed_t, b, grid * grid, c, canvas, canvas)
    ins_k = [a.clone().requires_grad_(True) for a in args]
    ins_p = [a.clone().requires_grad_(True) for a in args]
    out_k = windowed.fused_paste_render_windowed(*ins_k, seed_t, ys, noise_scale)
    out_p = windowed.render_windowed_reference(*ins_p, bands, noise)
    what = f"{shape} noise {noise_scale}"
    fwd_err, bwd_err, g_k = hold_to_plain(torch, f"windowed render {what}", out_k, out_p, ins_k,
                                          ins_p, seed)
    full_err = (out_k - render.fused_paste_render(*args, seed_t, noise_scale)).abs().max().item()
    if not full_err <= WINDOWED_VS_FULL_ATOL:
        fail(f"windowed render {what}: max |windowed - full-canvas kernel| {full_err:.3g} > "
             f"{WINDOWED_VS_FULL_ATOL}")
    outside = ~windowed.band_mask(bands, canvas)
    stray = int(torch.count_nonzero(g_k[1][outside]).item())
    if stray:
        fail(f"windowed render {what}: {stray} non-zero entries of g_wy outside the bands")
    rows = bands[..., 1].float()
    log(f"  windowed {what}: forward max err {fwd_err:.3g}, gradients max err {bwd_err:.3g}, "
        f"vs the full-canvas kernel {full_err:.3g}, g_wy zero outside the bands "
        f"(band rows: mean {rows.mean().item():.2f}, max {int(rows.max().item())} of {canvas})")
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


def windowed_bounds(shape, band_rows: int):
    """``bounds`` for the windowed pair, from this run's bands: ``band_rows``
    is the sum of the bands' lengths over all B*K cells.

    Bytes: as the full render's, but only the band's rows of wy are read (the
    backward still writes g_wy in full) and the bands themselves are read.
    Operations: the kernels' products all run over the band's rows: forward
    u = wy[band].obj and u.wx^T; the backward recomputes those and adds
    g_u = g_paste.wx, g_obj = wy^T.g_u, g_wy = g_u.obj^T, g_wx = g_paste^T.u.
    """
    b, grid, h, hh, c = shape
    k, c1, w, ww = grid * grid, c + 1, h, hh
    cells = b * k
    img_bytes = 4 * b * hh * ww * c
    read = 4 * (cells * (h * w * c1 + ww * w + 2 + 2) + band_rows * h) + img_bytes
    grads = 4 * cells * (h * w * c1 + hh * h + ww * w + 2) + img_bytes
    fwd_fma = band_rows * c1 * (w * h + ww * w)
    bwd_fma = fwd_fma + band_rows * c1 * (w * ww + h * w + h * w + ww * w)
    out = {}
    for name, nbytes, fma in (("fwd", read + img_bytes, fwd_fma),
                              ("bwd", read + img_bytes + grads, bwd_fma)):
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2 * fma / PEAK_FP32 * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
                     nbytes, 2 * fma)
    return out


def time_windowed(torch, render, windowed, shape, noise_scale):
    """Times of the windowed pair, its plain version and the full-canvas pair
    on the same inputs, in turns within one call; also the sum of band rows."""
    b, grid, os_, canvas, c = shape
    args, seed_t, ys = render_inputs(torch, b, grid, os_, canvas, c, 11)
    bands = windowed.compute_bands(ys, os_)
    noise = noise_scale * render.render_noise(seed_t, b, grid * grid, c, canvas, canvas)
    g = torch.rand((b, canvas, canvas, c), device="cuda")
    ins = [a.clone().requires_grad_(True) for a in args]
    out_p = windowed.render_windowed_reference(*ins, bands, noise)
    return {
        "full_fwd": cuda_ms(lambda: render._fwd(*args, seed_t, noise_scale)),
        "fwd": cuda_ms(lambda: windowed._fwd(*args, bands, seed_t, noise_scale)),
        "full_bwd": cuda_ms(lambda: render._bwd(*args, seed_t, noise_scale, g)),
        "bwd": cuda_ms(lambda: windowed._bwd(*args, bands, seed_t, noise_scale, g)),
        "plain_fwd": cuda_ms(lambda: windowed.render_windowed_reference(*args, bands, noise)),
        "plain_bwd": cuda_ms(lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True)),
        "bands": cuda_ms(lambda: windowed.compute_bands(ys, os_)),
        "band_rows": int(bands[..., 1].sum().item()),
    }


def time_render(torch, render, shape, noise_scale):
    b, grid, os_, canvas, c = shape
    args, seed_t, _ = render_inputs(torch, b, grid, os_, canvas, c, 11)
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
        res[name] = (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
                     nbytes, flops)
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


def kernel_family(name: str) -> str:
    """A coarse family for a CUDA kernel's name, for the step's breakdown."""
    low = name.lower()
    if "render_" in low:
        return "render kernels (this port)"
    if "crop_" in low:
        return "crop kernels (this port)"
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

    def permutation(self, n):
        self.drawn.append(self.noise.permutation(n))
        return self.drawn[-1]

    def seed(self):
        return self.noise.seed()


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


def small_vae_step_check(torch, np, cfg, hw):
    """One small LGVae train step on the card against the CPU, the same draws
    replayed; see ``hold_small_step``."""
    from split_vae_torch.core.noise import Noise
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.models.vae import get_vae_model
    from split_vae_torch.train.losses import lgvae_loss
    from split_vae_torch.train.optim import vae_optimizer
    from split_vae_torch.train.steps import augment, make_vae_train_step, normalize_images

    batch = torch.from_numpy(np.random.RandomState(1).randint(0, 255, (cfg.batch_size, *hw, 3))
                             .astype(np.uint8))
    cpu = get_vae_model(cfg, hw, device="cpu")
    gpu = get_vae_model(cfg, hw, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rec = RecordingNoise(Noise(torch.Generator().manual_seed(2)))
    with torch.no_grad():
        cpu(augment(cfg, normalize_images(batch, "tanh"), rec), True, rec)
    replay = rec.drawn

    grads = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        noise = Noise(torch.Generator(device=dev), replay)
        images = augment(cfg, normalize_images(batch.to(dev), "tanh"), noise)
        total, _ = lgvae_loss(model(images, True, noise), images, cfg.beta)
        grads.append([t.cpu() for t in torch.autograd.grad(total, list(model.parameters()))])
    results = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        state = create_train_state(model, vae_optimizer(cfg.learning_rate), seed=0)
        state, metrics = make_vae_train_step(cfg)(state, batch.to(dev), replay)
        results.append(({k: float(v) for k, v in metrics.items()},
                        [p.detach().cpu() for p in model.parameters()]))
    hold_small_step(torch, "LGVae", f"B={cfg.batch_size}, {hw[0]} px, patch {cfg.patch_size}",
                    [n for n, _ in cpu.named_parameters()], grads, results)


KERNELS = ("render_fwd", "render_bwd", "crop_fwd", "crop_bwd", "render_windowed_fwd",
           "render_windowed_bwd")


def reset_launches(render, crop, windowed):
    for module in (render, crop, windowed):
        module.fwd_launches = module.bwd_launches = 0


def read_launches(render, crop, windowed):
    return {"render_fwd": render.fwd_launches, "render_bwd": render.bwd_launches,
            "crop_fwd": crop.fwd_launches, "crop_bwd": crop.bwd_launches,
            "render_windowed_fwd": windowed.fwd_launches,
            "render_windowed_bwd": windowed.bwd_launches}


def timed_steps(torch, np, name, train_step, state, batches, batch_size):
    """WARMUP_STEPS + TRAIN_STEPS train steps; returns the state, the losses
    and the last step's metrics after checking that all is finite."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    losses = [v.item() for v in losses]
    notfinite = int(metrics["notfinite_updates"].item())
    log(f"{name}: {len(losses)} steps; losses {losses[0]:.2f} -> {losses[-1]:.2f}; "
        f"notfinite_updates {notfinite}")
    log(f"{name}: step {step_s * 1e3:.3f} ms, {batch_size / step_s:.1f} imgs/s "
        f"(mean of {TRAIN_STEPS} steps after {WARMUP_STEPS} warm-up)")
    if not all(np.isfinite(losses)):
        fail(f"{name}: non-finite loss {losses}")
    if notfinite != 0:
        fail(f"{name}: {notfinite} updates were skipped as non-finite")
    return state, losses


def log_profile(torch, name, train_step, state, batch):
    """Where the step's time goes (after the launch counts were read)."""
    n_prof = 3
    state, wall, busy, families = profile_steps(torch, train_step, state, batch, n_prof)
    if busy > 0:
        log(f"{name} profile: {n_prof} steps under torch.profiler, {wall / n_prof * 1e3:.3f} ms "
            f"a step on the host clock; device busy {busy / wall:.1%}, idle {1 - busy / wall:.1%}")
        for fam, (t, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
            log(f"  {fam}: {t / n_prof * 1e3:.3f} ms a step, {n // n_prof} launches a step")
    else:
        log(f"{name} profile: the profiler recorded no device time")
    return state


def run_path(torch, np, name, cfg, render, crop, windowed, windowed_render=False):
    """A SPAIR-family main path at full width: train steps through the kernels
    with the launch counts set to 0 before and read after, a profile, one eval
    step. ``windowed_render`` takes the row-windowed render pair, and then the
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
        f"{'row-windowed' if windowed_render else 'full-canvas'} render): B={cfg.batch_size}, "
        f"{sum(p.numel() for p in model.parameters())} params")
    reset_launches(render, crop, windowed)
    state, losses = timed_steps(torch, np, name, train_step, state, batches, cfg.batch_size)
    launches = read_launches(render, crop, windowed)
    used, unused = ("render_windowed", "render") if windowed_render else ("render",
                                                                          "render_windowed")
    for kernel, n in launches.items():
        if kernel.rsplit("_", 1)[0] == unused:
            if n != 0:
                fail(f"{name}: {kernel} kernel launched {n} times on a path that takes the "
                     f"{used} pair")
        elif n < len(losses) or (kernel.startswith("crop") and n != len(losses)):
            fail(f"{name}: {kernel} kernel launched {n} times in {len(losses)} steps")
    log(f"{name}: launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    state = log_profile(torch, name, train_step, state, batches[0])

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


def run_vae_path(torch, np, name, cfg, hw, render, crop, windowed):
    """The LGVae main path at full width: train steps on uint8 batches, a
    profile, one eval step. No hand-written kernel lies on it; the launch
    counts are read all the same and returned."""
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.models.vae import get_vae_model
    from split_vae_torch.train.optim import vae_optimizer
    from split_vae_torch.train.steps import make_vae_eval_step, make_vae_train_step

    model = get_vae_model(cfg, hw, device="cuda")
    state = create_train_state(model, vae_optimizer(cfg.learning_rate), seed=cfg.seed)
    train_step = make_vae_train_step(cfg)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(0, 255, (cfg.batch_size, *hw, 3)).astype(np.uint8))
               .cuda() for _ in range(2)]
    log(f"{name} ({cfg.model}, {hw[0]}x{hw[1]}, patch {cfg.patch_size}, latents "
        f"{cfg.global_latent_dims}/{cfg.local_latent_dims}, beta {cfg.beta}): "
        f"B={cfg.batch_size}, {sum(p.numel() for p in model.parameters())} params")
    reset_launches(render, crop, windowed)
    state, losses = timed_steps(torch, np, name, train_step, state, batches, cfg.batch_size)
    launches = read_launches(render, crop, windowed)
    if any(launches.values()):
        fail(f"{name}: a SPAIR kernel was launched on the LGVae path: {launches}")
    log(f"{name}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    state = log_profile(torch, name, train_step, state, batches[0])

    out, ev, images = make_vae_eval_step(cfg, model)(state.generator, batches[1])
    torch.cuda.synchronize()
    ev = {k: v.item() for k, v in ev.items()}
    if not all(np.isfinite(list(ev.values()))) or not all(torch.isfinite(t).all() for t in out):
        fail(f"{name}: non-finite eval result {ev}")
    if (tuple(out.x_mean.shape) != (cfg.batch_size, *hw, 3)
            or tuple(images.shape) != (cfg.batch_size, *hw, 6)):
        fail(f"{name}: eval x_mean {tuple(out.x_mean.shape)}, images {tuple(images.shape)}")
    log(f"{name} eval: total_loss {ev['total_loss']:.2f}, x_recon_loss {ev['x_recon_loss']:.2f}, "
        f"x_hat_recon_loss {ev['x_hat_recon_loss']:.2f}, total_kl_loss {ev['total_kl_loss']:.4f}")
    return launches, losses


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "split_vae_torch")):
        fail("split_vae_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from split_vae_torch.core.config import (
        CONFIG2_IMAGE_HW,
        SpairConfig,
        config2,
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
    for i, (shape, noise) in enumerate(render_cases + ((p3_shape, 0.0),)):
        keep("render_windowed", *compare_windowed(torch, render, windowed, shape, noise,
                                                  seed=i + 1))
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
        t, bd = time_render(torch, render, shape, 0.01), bounds(shape)
        for name in ("fwd", "bwd"):
            tb, by, nbytes, flops = bd[name]
            log(f"render {name} at {label} {shape}: kernel {t[name]:.4f} ms, plain "
                f"{t['plain_' + name]:.4f} ms, bound {tb:.4f} ms by {by} "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        if label == "P1/P2":
            for name in ("fwd", "bwd"):
                times["render_" + name] = (t[name], t["plain_" + name], None)
                bound["render_" + name] = bd[name]
    for label, shape in (("P4", cfg5_shape), ("28 on 48", p3_shape)):
        t = time_windowed(torch, render, windowed, shape, 0.01)
        bd = windowed_bounds(shape, t["band_rows"])
        cells = shape[0] * shape[1] ** 2
        log(f"windowed render at {label} {shape}: bands of {t['band_rows'] / cells:.2f} rows a "
            f"cell of {shape[3]}; compute_bands {t['bands']:.4f} ms")
        for name in ("fwd", "bwd"):
            tb, by, nbytes, flops = bd[name]
            log(f"windowed render {name} at {label}: kernel {t[name]:.4f} ms "
                f"({t[name] / t['full_' + name]:.3f} of the full-canvas kernel's "
                f"{t['full_' + name]:.4f} ms in the same turns), plain {t['plain_' + name]:.4f} "
                f"ms, bound {tb:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        if label == "P4":
            for name in ("fwd", "bwd"):
                times["render_windowed_" + name] = (t[name], t["plain_" + name], None)
                bound["render_windowed_" + name] = bd[name]
    for label, shape in (("P1/P2", crop_p1), ("P3", crop_p3)):
        t, bd = time_crop(torch, crop, shape), crop_bounds(shape)
        for name in ("fwd", "bwd", "bwd_all"):
            tb, by, nbytes, flops = bd[name]
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
                                            local_latent_dims=8), (32, 32))
    launches, losses = {}, {}
    for name, cfg, windowed_render in (("P1", config5(), False), ("P2", config_bg_spair(), False),
                                       ("P3", config_glimpse_spair(), False),
                                       ("P4", config5(), True)):
        launches[name], losses[name] = run_path(torch, np, name, cfg, render, crop, windowed,
                                                windowed_render)
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
    launches["P5"], losses["P5"] = run_vae_path(torch, np, "P5", config2(), CONFIG2_IMAGE_HW,
                                                render, crop, windowed)
    torch.cuda.empty_cache()

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
        t, by, _, _ = bound[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"split_vae_torch/csrc/{name.rsplit('_', 1)[0]}.cu",
            "replaces": replaces[name],
            "launches": sum(path[name] for path in launches.values()),
            "launches_by_path": {path: counts[name] for path, counts in launches.items()},
            "max_abs_err": errs[name], "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": t, "bound_by": by, "library_ms": library_ms,
            "library_chain_ms": chain_ms.get(name),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
