"""The full-canvas render pair's share of its roofline: the least time the
card could take for the forward and the backward kernel, over their traced
device time (the kernel names of the cell's ``rooflines.render``).

The least time of a kernel is the larger of its bytes at the card's
bandwidth and its FP32 operations at the FP32 peak (``peaks.json``). Bytes:
each input read once and each output written once, float32, all of the
objects counted. Forward: objs [B,K,h,w,C+1], ys [B,K,H], xs [B,K,W],
z_pres and depth_w [B,K], bg [B,H,W,C] in; the canvas [B,H,W,C] and the
composite's sums [B,C+2,H,W] out. Backward: the same inputs, the sums and
the cotangent in; the gradients of the six inputs out. Operations: the
composite's 7 + 6C (forward) and 12 + 8C (backward) a canvas pixel and
cell, which every pixel of every cell needs whatever its box; the paste's
taps, which depend on the boxes, are not counted.
"""


def shapes(t):
    """(B, K, object side, canvas side, C) of the cell."""
    from reference.lgspair import grid_hw
    cfg = t.cell.config["config"]
    h, w, c = cfg["image_size"]
    gh, gw = grid_hw((h, w))
    return t.cell.traffic["batch_size"], gh * gw, cfg["object_size"], h, c


def work(b, k, h, hh, c):
    """[(bytes, FLOP)] of the forward and the backward kernel."""
    cells, c1 = b * k, c + 1
    objs = 4 * cells * h * h * c1
    rest = 4 * (cells * (2 * hh + 2) + b * hh * hh * c)
    sums_g = 4 * b * hh * hh * (c + 2 + c)
    px = cells * hh * hh
    return [(objs + rest + sums_g, px * (7 + 6 * c)),
            (2 * (objs + rest) + sums_g, px * (12 + 8 * c))]


def least_s(pairs, peaks):
    return sum(max(n / peaks["bytes_per_s"], f / peaks["flops"]["float32"]) for n, f in pairs)


def read(t):
    kernels = t.cell.own.get("rooflines", {}).get("render")
    us = t.named_us(kernels) if kernels else 0.0
    if us <= 0:
        return None
    return 100.0 * least_s(work(*shapes(t)), t.peaks) / (us * 1e-6 / t.steps)
