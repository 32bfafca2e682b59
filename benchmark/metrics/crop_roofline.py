"""The glimpse crop pair's share of its roofline: the least time the card
could take for the forward and the backward kernel, over their traced device
time (the kernel names of the cell's ``rooflines.crop``).

The least time of a kernel is the larger of its bytes at the card's
bandwidth and its FP32 operations at the FP32 peak (``peaks.json``). Bytes:
each input read once, each output written once, float32. Forward: the image
[B,H,W,C] and the coordinates ys, xs [B,K,s] in, the glimpses [B,K,s,s,C]
out. Backward as the model calls it (the image takes no gradient): the
cotangent, the image and the coordinates in, the coordinates' gradients
out. Operations: 9 an output element forward (three products, three FMAs);
8 an element of the cotangent and 12 a glimpse pixel backward.
"""

from metrics.render_roofline import least_s


def shapes(t):
    """(B, K, canvas side, glimpse side, C) of the cell."""
    from reference.lgspair import grid_hw
    cfg = t.cell.config["config"]
    h, w, c = cfg["image_size"]
    gh, gw = grid_hw((h, w))
    return t.cell.traffic["batch_size"], gh * gw, h, cfg["object_size"], c


def work(b, k, hh, s, c):
    """[(bytes, FLOP)] of the forward and the backward kernel."""
    cells = b * k
    img, coords, out = 4 * b * hh * hh * c, 4 * cells * 2 * s, 4 * cells * s * s * c
    pix = cells * s * s
    return [(img + coords + out, 9 * pix * c), (out + img + 2 * coords, pix * (12 + 8 * c))]


def read(t):
    kernels = t.cell.own.get("rooflines", {}).get("crop")
    us = t.named_us(kernels) if kernels else 0.0
    if us <= 0:
        return None
    return 100.0 * least_s(work(*shapes(t)), t.peaks) / (us * 1e-6 / t.steps)
