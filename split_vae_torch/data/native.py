"""ctypes binding of the native (C++) MultiCUB generator
(split_vae_tpu/data/native.py).

Builds ``native/multicub_gen.cpp`` (the source the JAX package builds) with
``g++ -O3 -shared -fPIC`` into ``build/libmulticub_<digest>.so`` at the
repository root, where ``digest`` covers the source, at first use; it never
writes into ``native/``. A failed build raises with the compiler's output:
the numpy path makes other bytes, so it is no stand-in. ``generate`` returns
None only for a background mode the native code does not cover, which then
takes the numpy path, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "multicub_gen.cpp")
_BUILD_DIR = os.path.join(_REPO, "build")

# Per-mode native coverage (modes are spair/data.py:59-158):
#   solid_fixed / unseen_solid_fixed / solid_random / white  -> native
#   k x k checkerboard ('3x3_ckb' style)                     -> native (mode 3)
#   rotated checkerboard ('ckb_rot_6')                       -> native (mode 4)
#   texture (Kylberg files or procedural)                    -> native (mode 5,
#       bank built host-side by _texture_bank below)
# Anything else takes the numpy MultiCUB path.
BG_MODES = {
    "solid_fixed": 0,
    "unseen_solid_fixed": 0,
    "solid_random": 1,
    "white": 2,
}

_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libmulticub_{digest}.so")


def _build(out: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """The generator's library, built first if this source has none yet."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not os.path.exists(out):
        _build(out)
    lib = ctypes.CDLL(out)
    lib.multicub_generate.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,      # sprites, n_sprites
        ctypes.POINTER(ctypes.c_float),                    # out_images
        ctypes.POINTER(ctypes.c_float),                    # out_counts
        ctypes.c_int, ctypes.c_int, ctypes.c_int,          # n_samples, size, max_objects
        ctypes.c_int,                                      # bg_mode
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,      # palette, n_colors
        ctypes.c_int, ctypes.c_uint64,                     # cell, seed
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,      # textures, n_textures
    ]
    lib.multicub_generate.restype = None
    _lib = lib
    return lib


def _texture_bank(size: int, texture_dir: Optional[str], seed: int,
                  n_procedural: int = 256) -> np.ndarray:
    """Grayscale texture bank [T, size, size] in [0, 1].

    Kylberg files when present (spair/data.py:49,83-87), else the same
    procedural sin/cos texture family as the numpy path
    (data/multicub.py::MultiCUB._bg). The numpy path draws a fresh texture per
    sample; the native path samples from this bank.
    """
    files = sorted(glob.glob(os.path.join(texture_dir, "*.png"))) if texture_dir else []
    if files:
        from PIL import Image

        return np.stack([
            np.asarray(Image.open(f).convert("L").resize((size, size)), np.float32)
            / 255.0
            for f in files
        ])
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    bank = np.empty((n_procedural, size, size), np.float32)
    for i in range(n_procedural):
        f1, f2, ph = rng.uniform(4, 12), rng.uniform(4, 12), rng.uniform(0, 6)
        bank[i] = 0.5 + 0.25 * np.sin(f1 * xx + ph) * np.cos(f2 * yy)
    return bank


def generate(
    sprites: np.ndarray,
    n_samples: int,
    size: int,
    bg: str,
    palette: np.ndarray,
    max_objects: int = 5,
    seed: int = 0,
    texture_dir: Optional[str] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native batch generation; returns (images [N,S,S,3] in [0,1], counts),
    or None when the bg mode is not covered natively (see BG_MODES above)."""
    textures = np.zeros((0,), np.float32)
    if "rot" in bg:
        mode, cell = 4, int(bg[-1])
    elif "ckb" in bg:
        mode, cell = 3, int(bg[0]) if bg[0].isdigit() else 0
        if cell == 0:
            return None
    elif bg.replace("unseen_", "") == "texture":
        mode, cell = 5, 0
        textures = np.ascontiguousarray(
            _texture_bank(size, texture_dir, seed), np.float32)
    elif bg.replace("unseen_", "") in BG_MODES or bg in BG_MODES:
        mode, cell = BG_MODES.get(bg, BG_MODES.get(bg.replace("unseen_", ""), 0)), 0
    else:
        return None  # unknown mode: numpy path
    lib = load()

    sprites = np.ascontiguousarray(sprites, np.float32)
    palette = np.ascontiguousarray(palette, np.float32)
    out = np.empty((n_samples, size, size, 3), np.float32)
    counts = np.empty((n_samples,), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.multicub_generate(
        sprites.ctypes.data_as(fp), sprites.shape[0],
        out.ctypes.data_as(fp), counts.ctypes.data_as(fp),
        n_samples, size, max_objects, mode,
        palette.ctypes.data_as(fp), palette.shape[0], cell,
        ctypes.c_uint64(seed),
        textures.ctypes.data_as(fp), int(textures.shape[0]) if mode == 5 else 0)
    return out, counts
