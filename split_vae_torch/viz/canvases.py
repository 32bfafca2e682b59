"""The numpy canvases of the artifact writers (split_vae_tpu/viz/canvases.py).

The same arithmetic as the JAX package's, so the canvases are bit-equal to
its for the same inputs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def grid_canvas(images: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Tile [N, H, W, C] into a [rows*H, cols*W, C] canvas (row-major)."""
    n, h, w, c = images.shape
    if n < rows * cols:
        raise ValueError(f"{n} images for a {rows} x {cols} grid")
    canvas = np.empty((rows * h, cols * w, c), images.dtype)
    for i in range(rows):
        for j in range(cols):
            canvas[i * h:(i + 1) * h, j * w:(j + 1) * w] = images[i * cols + j]
    return canvas


def stack_rows(*row_batches: np.ndarray) -> np.ndarray:
    """Stack [N, H, W, C] batches vertically into a (len*H, N*W, C) canvas
    (the recon-vs-input strips, vae/visualizer.py:30-34)."""
    rows = []
    for batch in row_batches:
        n, h, w, c = batch.shape
        rows.append(batch.transpose(1, 0, 2, 3).reshape(h, n * w, c))
    return np.concatenate(rows, axis=0)


def to_unit(x: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1] clipped."""
    return np.clip((np.asarray(x) + 1.0) * 0.5, 0.0, 1.0)


def draw_bounding_boxes(images: np.ndarray, boxes: np.ndarray,
                        color: Sequence[float] = (1.0, 1.0, 1.0)) -> np.ndarray:
    """tf.image.draw_bounding_boxes in numpy: images [B, H, W, C] floats,
    boxes [B, K, 4] normalized [ymin, xmin, ymax, xmax]. Boxes of no height
    or width (the reference zeroes masked-out ones, spair/visualizer.py:109)
    are skipped rather than drawn as a corner pixel."""
    out = np.array(images, copy=True)
    b, h, w, c = out.shape
    col = np.asarray(color[:c], out.dtype)
    for bi in range(b):
        for k in range(boxes.shape[1]):
            ymin, xmin, ymax, xmax = boxes[bi, k]
            if ymax - ymin <= 0 or xmax - xmin <= 0:
                continue
            y0 = int(np.clip(round(ymin * (h - 1)), 0, h - 1))
            y1 = int(np.clip(round(ymax * (h - 1)), 0, h - 1))
            x0 = int(np.clip(round(xmin * (w - 1)), 0, w - 1))
            x1 = int(np.clip(round(xmax * (w - 1)), 0, w - 1))
            out[bi, y0, x0:x1 + 1] = col
            out[bi, y1, x0:x1 + 1] = col
            out[bi, y0:y1 + 1, x0] = col
            out[bi, y0:y1 + 1, x1] = col
    return out
