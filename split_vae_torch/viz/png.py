"""8-bit PNG files from numpy canvases, with ``zlib`` and ``struct`` alone.

The JAX package draws its figures with matplotlib (``imshow`` then
``savefig``); the port writes the canvas itself, one image pixel a canvas
pixel. Floats map to 8 bits as ``imshow`` shows them: an RGB canvas is clipped
to [0, 1]; a 2-D canvas (after ``np.squeeze``) is scaled from its minimum to
its maximum, as ``imshow`` with ``cmap="gray"`` does. A figure of several
panels (``write_panels``) puts them side by side with a white gap between
them; a gray panel beside RGB ones is repeated over the three channels.
Titles and colormaps are not drawn.

``read_png`` reads back what ``write_png`` writes (8-bit gray or RGB, filter
type 0): the tests and ``chip_smoke.py`` decode the files with it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
PANEL_GAP = 4  # white pixels between the panels of a figure
_COLOR_TYPES = {1: 0, 3: 2}  # channels -> PNG colour type (gray, RGB)


def to_uint8(canvas: np.ndarray) -> np.ndarray:
    """A float canvas as ``imshow`` shows it, in 8 bits: [H, W] gray
    (min-max scaled) or [H, W, 3] RGB (clipped to [0, 1])."""
    x = np.squeeze(np.asarray(canvas, dtype=np.float64))
    if x.ndim == 2:
        lo, hi = float(x.min()), float(x.max())
        x = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    elif x.ndim != 3 or x.shape[-1] != 3:
        raise ValueError(f"a canvas is [H, W] or [H, W, 3] after squeeze, not {x.shape}")
    return np.rint(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def join_panels(panels: Sequence[np.ndarray], gap: int = PANEL_GAP) -> np.ndarray:
    """8-bit panels side by side, top-aligned, ``gap`` white columns between
    them; RGB if any panel is."""
    rgb = any(p.ndim == 3 for p in panels)
    height = max(p.shape[0] for p in panels)
    cols = []
    for i, p in enumerate(panels):
        if rgb and p.ndim == 2:
            p = np.repeat(p[..., None], 3, axis=-1)
        if p.shape[0] < height:
            pad = np.full((height - p.shape[0],) + p.shape[1:], 255, np.uint8)
            p = np.concatenate([p, pad], axis=0)
        if i:
            cols.append(np.full((height, gap) + p.shape[2:], 255, np.uint8))
        cols.append(p)
    return np.concatenate(cols, axis=1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """The PNG bytes of a uint8 [H, W] or [H, W, 3] image: one IDAT, every row
    with filter type 0."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, not {image.dtype}")
    channels = 1 if image.ndim == 2 else image.shape[-1]
    if image.ndim not in (2, 3) or channels not in _COLOR_TYPES:
        raise ValueError(f"encode_png takes [H, W] or [H, W, 3], not {image.shape}")
    h, w = image.shape[:2]
    rows = image.reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[channels], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, canvas: np.ndarray) -> np.ndarray:
    """Writes a float canvas (or a uint8 image) to ``path``; returns the 8-bit image."""
    image = canvas if np.asarray(canvas).dtype == np.uint8 else to_uint8(canvas)
    with open(path, "wb") as f:
        f.write(encode_png(image))
    return image


def write_panels(path: str, panels: Sequence[np.ndarray]) -> np.ndarray:
    """Writes float panels side by side as one PNG; returns the 8-bit image."""
    return write_png(path, join_panels([to_uint8(p) for p in panels]))


def read_png(path: str) -> Tuple[np.ndarray, dict]:
    """Reads an 8-bit gray or RGB PNG whose rows all have filter type 0 (as
    ``encode_png`` writes them), checking every chunk's CRC. Returns the image
    ([H, W] or [H, W, 3] uint8) and the IHDR fields."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
            header = dict(width=w, height=h, bit_depth=depth, color_type=color,
                          interlace=interlace)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or header["bit_depth"] != 8 or header["interlace"] != 0:
        raise ValueError(f"{path}: read_png reads 8-bit, non-interlaced files; got {header}")
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(header["color_type"])
    if channels is None:
        raise ValueError(f"{path}: colour type {header['color_type']} is not gray or RGB")
    h, w = header["height"], header["width"]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * channels + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixels for {h} x {w} x {channels}")
    raw = raw.reshape(h, w * channels + 1)
    if raw[:, 0].any():
        raise ValueError(f"{path}: a row has filter type {int(raw[:, 0].max())}; read_png "
                         f"reads type 0 only")
    image = raw[:, 1:].reshape(h, w, channels)
    return (image[..., 0] if channels == 1 else image), header
