"""Batches on the device (split_vae_tpu/data/loader.py).

Images stay in their storage dtype (uint8 for photos, float32 for the MultiCUB
canvases); normalization and augmentation run on the device
(train/steps.py). Two paths feed the train loop:

- ``device_resident_batches``: the dataset goes to the device once; each
  epoch's permutation goes up once, and a batch is an ``index_select`` on the
  device, so a step copies nothing between host and device.
- ``device_prefetch`` over ``iterate_batches``: host batches copied from
  pinned memory without blocking, ``size`` batches in flight; for datasets
  over ``DEVICE_RESIDENT_MAX_BYTES`` or with ``-host_data``.

Both read one index stream (``_epoch_index_batches``): for a seed, the JAX
package's ``np.random.RandomState`` permutations, so the two packages and the
two paths see the same examples in the same order. Batches drop the
remainder.

Data parallelism (``parallel/mesh.py``): in ``device_resident_batches`` each
rank takes its rows (``rows``) of the global batch of the same permutation,
the JAX single-process mesh's order, which is the 1-rank order; in
``iterate_batches`` process k of N streams batches of its own disjoint 1/N
slice of each epoch's permutation (``process_index``, ``process_count``),
index for index the JAX package's pod path.
"""

from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from split_vae_torch.core import tracing


@dataclass
class ArrayDataset:
    """In-memory dataset: images [N, H, W, C] (+ optional labels [N, ...])."""

    images: np.ndarray
    labels: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def image_shape(self):
        return self.images.shape[1:]


def _epoch_orders(n_total: int, shuffle: bool, repeat: bool, seed: int) -> Iterator[np.ndarray]:
    """Each epoch's example order: a permutation from the shared seed, or range(n)."""
    rng = np.random.RandomState(seed)
    while True:
        yield rng.permutation(n_total) if shuffle else np.arange(n_total)
        if not repeat:
            return


def _batch_starts(n: int, batch_size: int, drop_remainder: bool) -> range:
    return range(0, n - n % batch_size if drop_remainder else n, batch_size)


def _epoch_index_batches(
    n_total: int,
    batch_size: int,
    shuffle: bool,
    repeat: bool,
    seed: int,
    drop_remainder: bool,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """The index stream: one permutation per epoch, cut into batches. With
    ``process_count`` N > 1, process k takes the k-th of N equal disjoint
    slices of each permutation (the remainder dropped) and cuts it into
    batches of ``batch_size``, its own share of the global batch
    (split_vae_tpu/data/loader.py:40-78)."""
    pc = process_count or 1
    pi = process_index or 0
    orders = _epoch_orders(n_total, shuffle, repeat, seed)
    while True:
        with tracing.span("loader.epoch"):
            idx = next(orders, None)
        if idx is None:
            return
        if pc > 1:
            per_process = n_total // pc
            idx = idx[pi * per_process:(pi + 1) * per_process]
        for start in _batch_starts(len(idx), batch_size, drop_remainder):
            yield idx[start:start + batch_size]


def iterate_batches(
    ds: ArrayDataset,
    batch_size: int,
    shuffle: bool = True,
    repeat: bool = False,
    seed: int = 0,
    drop_remainder: bool = True,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Iterator:
    """Yield (images, labels) or images host batches; reshuffles every epoch."""
    for sel in _epoch_index_batches(len(ds), batch_size, shuffle, repeat, seed,
                                    drop_remainder, process_index, process_count):
        imgs = ds.images[sel]
        if ds.labels is not None:
            yield imgs, ds.labels[sel]
        else:
            yield imgs


# Datasets up to this many bytes live on the device. The largest dataset here,
# MultiCUB's 100k float32 48x48x3 canvases, is 2.8 GB; the limit keeps most
# of an 80 GB card for training.
DEVICE_RESIDENT_MAX_BYTES = 6 << 30


def device_resident_batches(
    ds: ArrayDataset,
    batch_size: int,
    shuffle: bool = True,
    repeat: bool = False,
    seed: int = 0,
    drop_remainder: bool = True,
    device="cuda",
    rows: slice = slice(None),
) -> Iterator:
    """Batches gathered on ``device`` from a copy of the dataset made there
    once; the order is ``iterate_batches``'s. ``rows`` takes this rank's rows
    of each batch of ``batch_size`` (the global batch)."""
    device = torch.device(device)
    imgs = torch.from_numpy(np.ascontiguousarray(ds.images)).to(device)
    labels = (torch.from_numpy(np.ascontiguousarray(ds.labels)).to(device)
              if ds.labels is not None else None)
    orders = _epoch_orders(len(ds), shuffle, repeat, seed)
    starts = iter(())
    while True:
        with tracing.span("loader.next"):
            start = next(starts, None)
            while start is None:
                with tracing.span("loader.epoch"):
                    idx = next(orders, None)
                    if idx is None:
                        return
                    order = torch.from_numpy(idx).to(device)
                starts = iter(_batch_starts(len(idx), batch_size, drop_remainder))
                start = next(starts, None)
            sel = order[start:start + batch_size][rows]
            batch = imgs.index_select(0, sel)
            out = (batch, labels.index_select(0, sel)) if labels is not None else batch
        yield out


def to_device(x: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device`` (a blocking copy; the eval sweeps' batches)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _put(batch, device: torch.device):
    if isinstance(batch, tuple):
        return tuple(_put(b, device) for b in batch)
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(iterator: Iterator, size: int = 2, device="cuda") -> Iterator:
    """Keep ``size`` batches copied (or copying) to ``device`` ahead of the consumer."""
    device = torch.device(device)
    iterator = iter(iterator)
    queue = collections.deque()
    while True:
        with tracing.span("loader.next"):
            while len(queue) < size:
                batch = next(iterator, None)
                if batch is None:
                    break
                queue.append(_put(batch, device))
            if not queue:
                return
            out = queue.popleft()
        yield out


def take(iterator: Iterator, n: int):
    return itertools.islice(iterator, n)
