"""SVHN dataset loader (split_vae_tpu/data/svhn.py).

Reference: vae/data.py:23-75. Images are stored as uint8 [N, 32, 32, 3] on the
host (normalization to [-1, 1] happens on the device, train/steps.py); labels
are one-hot float32 with the reference's digit-0-stored-as-class-10 remap
(``y - 1``, vae/data.py:56).

The reference downloads three .mat files from ufldl.stanford.edu; here they
are read from ``<data_dir>/SVHN/`` and never downloaded. ``-synthetic_data``
gives a deterministic stand-in with the same shapes and dtypes.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from split_vae_torch.data.loader import ArrayDataset

_URLS = {
    "train_32x32.mat": "http://ufldl.stanford.edu/housenumbers/train_32x32.mat",
    "extra_32x32.mat": "http://ufldl.stanford.edu/housenumbers/extra_32x32.mat",
    "test_32x32.mat": "http://ufldl.stanford.edu/housenumbers/test_32x32.mat",
}


def _load_mat(path: str) -> Tuple[np.ndarray, np.ndarray]:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"SVHN file missing: put {os.path.basename(path)} (from "
            f"{_URLS[os.path.basename(path)]}) at {path}, or pass -synthetic_data")
    from scipy.io import loadmat

    data = loadmat(path)
    x = data["X"].transpose(3, 0, 1, 2)  # [N, 32, 32, 3] uint8
    y = data["y"].reshape(-1)
    return np.ascontiguousarray(x), y


def _one_hot_labels(y: np.ndarray) -> np.ndarray:
    """Digit 0 is stored as class 10; reference maps via y-1 (vae/data.py:56)."""
    return np.eye(10, dtype=np.float32)[(y - 1).astype(np.int64)]


def synthetic_svhn(n_train: int = 512, n_test: int = 128, seed: int = 0):
    """Deterministic stand-in with SVHN shapes (offline testing/benching)."""
    rng = np.random.RandomState(seed)

    def make(n):
        # Smooth colored blobs so models can actually learn something.
        yy, xx = np.mgrid[0:32, 0:32] / 32.0
        imgs = np.zeros((n, 32, 32, 3), np.float32)
        labels = rng.randint(0, 10, n)
        for i in range(n):
            f = 1 + labels[i]
            imgs[i, :, :, 0] = 0.5 + 0.5 * np.sin(f * xx * 3 + rng.rand() * 6)
            imgs[i, :, :, 1] = 0.5 + 0.5 * np.cos(f * yy * 3 + rng.rand() * 6)
            imgs[i, :, :, 2] = (xx + yy) / 2
        return (imgs * 255).astype(np.uint8), labels + 1  # .mat-style 1..10

    x_train, y_train = make(n_train)
    x_test, y_test = make(n_test)
    return x_train, y_train, x_test, y_test


# 3x5 segment glyphs for the "digits" synthetic flavor.
_DIGIT_GLYPHS = np.array([
    # 0        1        2        3        4
    [[1, 1, 1], [0, 1, 0], [1, 1, 1], [1, 1, 1], [1, 0, 1]],
    [[1, 0, 1], [1, 1, 0], [0, 0, 1], [0, 0, 1], [1, 0, 1]],
    [[1, 0, 1], [0, 1, 0], [1, 1, 1], [0, 1, 1], [1, 1, 1]],
    [[1, 0, 1], [0, 1, 0], [1, 0, 0], [0, 0, 1], [0, 0, 1]],
    [[1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [0, 0, 1]],
], dtype=np.float32).transpose(1, 0, 2)  # -> [digit(0-4), 5, 3] after stack fix
_DIGIT_GLYPHS_59 = np.array([
    # 5        6        7        8        9
    [[1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1]],
    [[1, 0, 0], [1, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 1]],
    [[1, 1, 1], [1, 1, 1], [0, 1, 0], [1, 1, 1], [1, 1, 1]],
    [[0, 0, 1], [1, 0, 1], [0, 1, 0], [1, 0, 1], [0, 0, 1]],
    [[1, 1, 1], [1, 1, 1], [1, 0, 0], [1, 1, 1], [1, 1, 1]],
], dtype=np.float32).transpose(1, 0, 2)


def _glyph(digit: int) -> np.ndarray:
    """5x3 binary bitmap of a digit (segment-display style)."""
    if digit < 5:
        return _DIGIT_GLYPHS[digit]
    return _DIGIT_GLYPHS_59[digit - 5]


def synthetic_svhn_digits(n_train: int = 512, n_test: int = 128, seed: int = 0):
    """Clusterable synthetic SVHN: rendered digit glyphs, SVHN shapes/labels.

    Unlike the ``blobs`` stand-in (whose sinusoid classes alias — LGGMVae
    cluster accuracy plateaus near chance on it, BASELINE.md), each class here
    is a visually distinct glyph: 5x3 segment bitmaps upscaled to 25x15,
    jittered +-1 px, bright foreground on a dark background with random
    colors. Shape, not color, carries the class — exactly the structure the
    GMVAE's Gumbel-softmax clustering objective (vae/model.py:170-249) is
    meant to discover. Offline demonstration data only; never the default.
    """
    rng = np.random.RandomState(seed)

    def make(n):
        labels = rng.randint(0, 10, n)
        imgs = np.zeros((n, 32, 32, 3), np.float32)
        for i in range(n):
            glyph = np.kron(_glyph(labels[i]), np.ones((5, 5), np.float32))
            # Nuisance ranges are deliberately tight: measured with
            # 30-means-on-pixels + linear assignment, wider color ranges /
            # +-3 px jitter cap even the PIXEL-space ceiling at ~0.44 (and the
            # GMVAE at ~0.28); these values give a ~0.6 pixel ceiling while
            # keeping random colors and position so shape must carry the class.
            bg = rng.uniform(0.0, 0.15, 3)
            fg = rng.uniform(0.75, 1.0, 3)
            imgs[i] = bg[None, None]
            oy = 3 + rng.randint(-1, 2)
            ox = 8 + rng.randint(-1, 2)
            m = glyph[..., None]
            region = imgs[i, oy:oy + 25, ox:ox + 15]
            imgs[i, oy:oy + 25, ox:ox + 15] = region * (1 - m) + m * fg[None, None]
        return (imgs * 255).astype(np.uint8), labels + 1  # .mat-style 1..10

    x_train, y_train = make(n_train)
    x_test, y_test = make(n_test)
    return x_train, y_train, x_test, y_test


def get_svhn(config, extra: bool = True):
    """Returns (train ArrayDataset, test ArrayDataset, input_shape [-1,H,W,C]).

    The real files are read from ``<data_dir>/SVHN/``; a missing one raises,
    naming the path to put it at (nothing is downloaded)."""
    if config.synthetic_data:
        gen = (synthetic_svhn_digits
               if getattr(config, "synthetic_style", "blobs") == "digits"
               else synthetic_svhn)
        x_train, y_train, x_test, y_test = gen(
            n_train=getattr(config, "synthetic_size", 0) or 512,
            n_test=max(128, (getattr(config, "synthetic_size", 0) or 512) // 8),
            seed=config.seed)
        x_extra = x_train[:0]
        y_extra = y_train[:0]
    else:
        data_path = os.path.join(config.data_dir, "SVHN")
        x_train, y_train = _load_mat(os.path.join(data_path, "train_32x32.mat"))
        x_test, y_test = _load_mat(os.path.join(data_path, "test_32x32.mat"))
        if extra:
            x_extra, y_extra = _load_mat(os.path.join(data_path, "extra_32x32.mat"))
        else:
            x_extra = x_train[:0]
            y_extra = y_train[:0]

    if extra and len(x_extra):
        x_train = np.concatenate([x_train, x_extra])
        y_train = np.concatenate([y_train, y_extra])

    get_label = config.label
    train = ArrayDataset(x_train, _one_hot_labels(y_train) if get_label else None)
    test = ArrayDataset(x_test, _one_hot_labels(y_test) if get_label else None)
    return train, test, [-1, 32, 32, 3]
