"""Multi-CUB synthetic object-detection dataset generator
(split_vae_tpu/data/multicub.py).

Reference: spair/data.py:39-278. Composits 0-5 masked 14x14 CUB bird crops
onto 48x48 canvases with <=15% box-overlap rejection sampling and alpha
compositing; disjoint train/test background color palettes; writes
100k-train / 1k-test / 1k-unseen-test splits with per-image object counts.

Host-side, one-time generation, cached as compressed .npz under the JAX
package's name and layout, so either package reads the other's cache. The
CUB source crops (``cub_train_seg_14x14_pad_20_masked.npy``) are read from
``data_dir`` when present; otherwise, or with ``-synthetic_data``,
deterministic synthetic bird-like sprites take their place.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

from split_vae_torch.data.loader import ArrayDataset

SPRITE = 14  # crop size (spair/data.py:35,47)

# Palettes (spair/data.py:52-57)
TRAIN_COLORS_TRIAD = [(195, 135, 255), (193, 255, 135), (255, 165, 135),
                      (81, 197, 255), (255, 229, 81), (255, 81, 139)]
TEST_COLORS_TRIAD = [(255, 125, 227), (125, 255, 184), (255, 205, 125)]
TRAIN_COLORS = [(100, 209, 72), (209, 72, 100), (209, 127, 72), (72, 129, 209),
                (84, 184, 209), (209, 109, 84), (184, 209, 84), (109, 84, 209)]
TEST_COLORS = [(222, 222, 102), (100, 100, 219), (219, 100, 219), (100, 219, 100)]


def _intersection(a0, a1, b0, b1):
    """1-D interval intersection length (spair/data.py:18-29)."""
    if a0 >= b0 and a1 <= b1:
        return a1 - a0
    if a0 < b0 and a1 > b1:
        return b1 - b0
    if a0 < b0 and a1 > b0:
        return a1 - b0
    if a1 > b1 and a0 < b1:
        return b1 - a0
    return 0


def _overlaps(rand_x, rand_y, drawn, thresh=0.15):
    for (x, y) in drawn:
        area = (_intersection(rand_x, rand_x + SPRITE, x, x + SPRITE)
                * _intersection(rand_y, rand_y + SPRITE, y, y + SPRITE))
        if area / SPRITE**2 > thresh:
            return True
    return False


def synthetic_sprites(n: int = 256, seed: int = 0,
                      min_color: float = 60.0) -> np.ndarray:
    """Bird-ish 14x14 masked sprites in [0, 255] with zero background,
    matching the CUB npy's contract (nonzero pixels = foreground,
    spair/data.py:143).

    ``min_color`` raises the sprite color floor — the contrast knob for the
    Multi-Bird-Hard anti-collapse ablation (dark sprites on the rotating
    checkerboard are the low-contrast regime where the z_pres anneal can
    trade all objects away). Default 60 is the shipped behavior.
    """
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:SPRITE, 0:SPRITE].astype(np.float64)
    sprites = np.zeros((n, SPRITE, SPRITE, 3), np.float32)
    for i in range(n):
        cx, cy = rng.uniform(5, 9, 2)
        ax, ay = rng.uniform(2.0, 4.5, 2)
        theta = rng.uniform(0, math.pi)
        dx, dy = xx - cx, yy - cy
        rx = dx * math.cos(theta) + dy * math.sin(theta)
        ry = -dx * math.sin(theta) + dy * math.cos(theta)
        body = ((rx / ax) ** 2 + (ry / ay) ** 2) <= 1.0
        color = rng.uniform(min_color, 255, 3)
        for c in range(3):
            sprites[i, :, :, c] = body * color[c] * (0.7 + 0.3 * (yy / SPRITE))
    return sprites


class MultiCUB:
    """Canvas compositor (spair/data.py:39-174)."""

    def __init__(self, sprites_train: np.ndarray, sprites_test: Optional[np.ndarray] = None,
                 seed: int = 0, texture_dir: Optional[str] = None):
        self.train_x = sprites_train
        self.test_x = sprites_test if sprites_test is not None else sprites_train
        self.rng = np.random.RandomState(seed)
        self.num_channel = sprites_train.shape[-1]
        self.texture_dir = texture_dir  # data/kylberg in the reference

    # -- backgrounds ---------------------------------------------------------
    def _bg(self, bg: str, width: int, height: int) -> np.ndarray:
        rng = self.rng
        canvas = np.zeros([width, height, self.num_channel], np.float32)
        if bg == "solid_random":
            brightness = rng.randint(0, 256)
            canvas[:] = rng.randint(0, max(brightness, 1), 3)[None, None] / 255.0
        elif bg == "solid_fixed":
            canvas[:] = np.array(TRAIN_COLORS[rng.randint(len(TRAIN_COLORS))]) / 255.0
        elif bg == "unseen_solid_fixed":
            canvas[:] = np.array(TEST_COLORS[rng.randint(len(TEST_COLORS))]) / 255.0
        elif bg == "white":
            canvas[:] = 1.0
        elif bg == "texture":
            # Kylberg grayscale textures (spair/data.py:49,83-87) when present;
            # otherwise a smooth procedural texture so the mode works offline.
            import glob as _glob
            files = sorted(_glob.glob(os.path.join(self.texture_dir, "*.png"))) \
                if self.texture_dir else []
            if files:
                from PIL import Image
                img = np.asarray(
                    Image.open(files[rng.randint(len(files))]).convert("L")
                    .resize((width, height)), np.float32) / 255.0
                canvas[:] = img[:, :, None]
            else:
                yy, xx = np.mgrid[0:width, 0:height] / width
                f1, f2, ph = rng.uniform(4, 12), rng.uniform(4, 12), rng.uniform(0, 6)
                tex = 0.5 + 0.25 * np.sin(f1 * xx + ph) * np.cos(f2 * yy)
                canvas[:] = tex[:, :, None].astype(np.float32)
        elif "rot" in bg:  # e.g. 'ckb_rot_6' / 'unseen_ckb_rot_6'
            palette = TEST_COLORS_TRIAD if "unseen" in bg else TRAIN_COLORS_TRIAD
            colors = [palette[i] for i in rng.permutation(len(palette))[:2]]
            cell = int(bg[-1])
            big = np.zeros([width * 4, height * 4, 3], np.float32)
            num = (height * 4) // cell
            for i in range(num):
                for j in range(num):
                    big[i * cell:(i + 1) * cell, j * cell:(j + 1) * cell] = (
                        np.array(colors[(i + j) % 2]) / 255.0)
            angle_rad = rng.uniform(-1, 1) * math.pi / 2
            import scipy.ndimage

            rot = scipy.ndimage.rotate(
                big, np.degrees(angle_rad), axes=(0, 1), reshape=False, order=1,
                mode="constant")
            # central_crop(0.25) (spair/data.py:105)
            h4, w4 = rot.shape[:2]
            y0 = (h4 - height) // 2
            x0 = (w4 - width) // 2
            canvas = rot[y0:y0 + height, x0:x0 + width].astype(np.float32)
        elif "ckb" in bg:
            palette = TEST_COLORS if "unseen" in bg else TRAIN_COLORS
            colors = [palette[i] for i in rng.permutation(len(palette))[:2]]
            num = int(bg[0])
            h, w = height // num, width // num
            for i in range(num):
                for j in range(num):
                    canvas[i * h:(i + 1) * h, j * w:(j + 1) * w] = (
                        np.array(colors[(i + j) % 2]) / 255.0)
        return canvas

    def create_sample(self, n: int, width: int, height: int, bg: str,
                      test: bool = False) -> np.ndarray:
        canvas = self._bg(bg, width, height)
        drawn = []
        src = self.test_x if test else self.train_x
        for _ in range(n):
            rx = self.rng.randint(0, width - SPRITE)
            ry = self.rng.randint(0, height - SPRITE)
            tries = 0
            while _overlaps(rx, ry, drawn) and tries < 1000:
                rx = self.rng.randint(0, width - SPRITE)
                ry = self.rng.randint(0, height - SPRITE)
                tries += 1
            drawn.append((rx, ry))
            img = src[self.rng.randint(0, src.shape[0])]
            alpha = (img.max(axis=-1) > 0).astype(np.float32)[:, :, None]
            canvas[rx:rx + SPRITE, ry:ry + SPRITE] = (
                alpha * img / 255.0
                + (1.0 - alpha) * canvas[rx:rx + SPRITE, ry:ry + SPRITE])
        return canvas

    def create_dataset(self, nsamples: int, digits: Tuple[int, int], size: int,
                       bg: str, test: bool = False):
        buf = np.zeros([nsamples, size, size, self.num_channel], np.float32)
        counts = np.zeros([nsamples], np.float32)
        for i in range(nsamples):
            n = self.rng.randint(digits[0], digits[1] + 1)
            counts[i] = n
            buf[i] = self.create_sample(n, size, size, bg, test)
        if test:
            return buf, counts
        return buf


def _load_sprites(data_dir: str, synthetic: bool, seed: int,
                  sprite_min_color: float = 60.0):
    train_npy = os.path.join(data_dir, "cub_train_seg_14x14_pad_20_masked.npy")
    test_npy = os.path.join(data_dir, "cub_test_seg_14x14_pad_20_masked.npy")
    if not synthetic and os.path.exists(train_npy):
        train = np.load(train_npy).astype(np.float32)
        test = np.load(test_npy).astype(np.float32) if os.path.exists(test_npy) else None
        return train, test
    return (synthetic_sprites(256, seed, sprite_min_color),
            synthetic_sprites(64, seed + 1, sprite_min_color))


def create_multicub_cache(
    name: str, data_dir: str, n_train: int = 100_000, n_eval: int = 1_000,
    synthetic: bool = False, seed: int = 0, size: int = 48,
    sprite_min_color: float = 60.0,
) -> str:
    """Generate and cache the three splits (spair/data.py:229-255)."""
    if name not in ("cub_solid_fixed", "cub_ckb_rot_6"):
        raise NotImplementedError(f"Undefined dataset: {name}")
    bg = name[4:]
    cache_dir = os.path.join(data_dir, "multi_cub")
    os.makedirs(cache_dir, exist_ok=True)
    contrast_tag = "" if sprite_min_color == 60.0 else f"_c{int(sprite_min_color)}"
    path = os.path.join(cache_dir, f"{name}_{n_train}_{n_eval}{contrast_tag}.npz")
    if os.path.exists(path):
        return path
    sprites_train, sprites_test = _load_sprites(
        data_dir, synthetic, seed, sprite_min_color)

    def _palette(bg_name: str) -> np.ndarray:
        if "rot" in bg_name:
            cols = TEST_COLORS_TRIAD if "unseen" in bg_name else TRAIN_COLORS_TRIAD
        else:
            cols = TEST_COLORS if "unseen" in bg_name else TRAIN_COLORS
        return np.asarray(cols, np.float32) / 255.0

    def _make(n: int, bg_name: str, sprites: np.ndarray, split_seed: int):
        # The native C++ generator for every mode it covers; the numpy path
        # for the others.
        from split_vae_torch.data import native

        result = native.generate(sprites, n, size, bg_name, _palette(bg_name),
                                 max_objects=5, seed=split_seed)
        if result is not None:
            return result
        # numpy path: the requested sprite bank for both slots and the
        # test=True path so counts are always returned.
        cub = MultiCUB(sprites, sprites, seed=split_seed)
        return cub.create_dataset(n, digits=(0, 5), size=size, bg=bg_name, test=True)

    test_unseen, count_unseen = _make(n_eval, "unseen_" + bg, sprites_test, seed + 1)
    train, _ = _make(n_train, bg, sprites_train, seed)
    test, count_test = _make(n_eval, bg, sprites_test, seed + 2)
    np.savez_compressed(
        path, train=train, test=test, count_test=count_test,
        test_unseen=test_unseen, count_unseen=count_unseen)
    return path


def get_multicub(config, n_train: Optional[int] = None, n_eval: Optional[int] = None,
                 sprite_min_color: float = 60.0):
    """Returns (train ds, [test ds, unseen test ds], input_shape, test_shape).

    Mirrors get_cub_dataset (spair/data.py:258-278).
    """
    if n_train is None:
        n_train = (getattr(config, "synthetic_size", 0) or 2048) \
            if config.synthetic_data else 100_000
    n_eval = n_eval if n_eval is not None else (256 if config.synthetic_data else 1_000)
    path = create_multicub_cache(
        config.dataset, config.data_dir, n_train=n_train, n_eval=n_eval,
        synthetic=config.synthetic_data, seed=config.seed,
        sprite_min_color=sprite_min_color)
    with np.load(path) as z:
        train = ArrayDataset(z["train"])
        test = ArrayDataset(z["test"], z["count_test"] if config.label else None)
        unseen = ArrayDataset(z["test_unseen"], z["count_unseen"] if config.label else None)
    size = train.images.shape[1]
    shape = [-1, size, size, train.images.shape[-1]]
    return train, [test, unseen], shape, shape
