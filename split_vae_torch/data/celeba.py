"""CelebA 64x64 (and 128x128) loader (split_vae_tpu/data/celeba.py).

Reference: vae/data.py:77-134 — center-crop 178, bilinear resize, 90/10
test/train split by file order, one-time serialization (TFRecord there, a
memory-mappable uint8 .npy cache here, the JAX package's file names).

Nothing is downloaded: point ``data_dir`` at an existing
``celeba/img_align_celeba`` folder or cache, or pass ``-synthetic_data``.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from split_vae_torch.data.loader import ArrayDataset


def _preprocess_one(path: str, size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    # tf.image.resize_with_crop_or_pad(178, 178): center crop (or pad) then resize
    left = (w - 178) // 2
    top = (h - 178) // 2
    img = img.crop((left, top, left + 178, top + 178))
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def build_celeba_cache(raw_dir: str, cache_dir: str, size: int = 64) -> None:
    """One-time serialization of the jpg folder into train/test uint8 .npy."""
    files = sorted(glob(os.path.join(raw_dir, "*")))
    if not files:
        raise FileNotFoundError(f"No CelebA images under {raw_dir}")
    n_test = len(files) // 10  # reference split: first 10% test (vae/data.py:90-91)
    os.makedirs(cache_dir, exist_ok=True)
    for split, split_files in (("test", files[:n_test]), ("train", files[n_test:])):
        out = np.lib.format.open_memmap(
            os.path.join(cache_dir, f"{split}_{size}x{size}.npy"),
            mode="w+", dtype=np.uint8, shape=(len(split_files), size, size, 3),
        )
        for i, f in enumerate(split_files):
            out[i] = _preprocess_one(f, size)
        out.flush()


def synthetic_celeba(size: int = 64, n_train: int = 512, n_test: int = 128, seed: int = 0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size

    def make(n):
        imgs = np.zeros((n, size, size, 3), np.float32)
        for i in range(n):
            cx, cy, r = rng.rand(3) * 0.6 + 0.2
            face = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (0.05 + 0.1 * r)))
            imgs[i, :, :, 0] = 0.3 + 0.6 * face
            imgs[i, :, :, 1] = 0.2 + 0.5 * face * (0.5 + 0.5 * np.sin(6 * xx))
            imgs[i, :, :, 2] = 0.2 + 0.4 * (1 - face)
        return (imgs * 255).astype(np.uint8)

    return make(n_train), make(n_test)


def get_celeba(config, size: int = 64):
    """Returns (train, test ArrayDatasets, input_shape).

    Reads the uint8 ``.npy`` cache under ``<data_dir>/celeba/``, building it
    first from ``<data_dir>/celeba/img_align_celeba`` when only that exists;
    raises, naming both, when neither does."""
    if config.synthetic_data:
        n = getattr(config, "synthetic_size", 0) or 512
        x_train, x_test = synthetic_celeba(
            size=size, n_train=n, n_test=max(128, n // 8), seed=config.seed)
    else:
        cache_dir = os.path.join(config.data_dir, "celeba")
        train_path = os.path.join(cache_dir, f"train_{size}x{size}.npy")
        test_path = os.path.join(cache_dir, f"test_{size}x{size}.npy")
        if not (os.path.exists(train_path) and os.path.exists(test_path)):
            raw = os.path.join(cache_dir, "img_align_celeba")
            if not os.path.isdir(raw):
                raise FileNotFoundError(
                    f"CelebA missing: neither the cache {train_path} and {test_path} nor "
                    f"the image folder {raw} exists; put one there, or pass -synthetic_data")
            print("Creating CelebA uint8 cache (one-time)")
            build_celeba_cache(raw, cache_dir, size)
        x_train = np.load(train_path, mmap_mode="r")
        x_test = np.load(test_path, mmap_mode="r")
    # CelebA is used with -no_label only (vae/main.py README commands).
    return ArrayDataset(x_train), ArrayDataset(x_test), [-1, size, size, 3]
