"""The benchmark's inputs, all made from ``--seed``: the seeds of each part,
the dataset, and the rows the loader serves first, worked out again."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch


@dataclass(frozen=True)
class Seeds:
    weights: int
    data: int
    draws: int
    state: int   # the program's generator
    loader: int  # the loader's epoch order (32 bits)


def derive(seed: int) -> Seeds:
    """Independent seeds of every part of a run from one whole number of any size."""
    w = [int(v) for v in np.random.SeedSequence(seed % (1 << 128)).generate_state(5, np.uint64)]
    return Seeds(weights=w[0], data=w[1], draws=w[2], state=w[3], loader=w[4] & 0xFFFFFFFF)


def make_images(spec: Dict, seed: int, device) -> np.ndarray:
    """The dataset of ``spec`` ({"count", "shape", "dtype"}): uniform noise made
    on ``device`` in one call, then held by the host as the loader takes it."""
    shape = (int(spec["count"]),) + tuple(spec["shape"])
    g = torch.Generator(device=device).manual_seed(seed)
    if spec["dtype"] == "uint8":
        t = torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)
    elif spec["dtype"] == "float32":
        t = torch.rand(shape, generator=g, device=device)
    else:
        raise ValueError(f"dataset dtype {spec['dtype']!r}: uint8 or float32")
    return t.cpu().numpy()


def first_rows(n: int, batch: int, loader_seed: int, steps: int) -> List[np.ndarray]:
    """The indices of the first ``steps`` batches of a shuffled epoch, as the
    SPLIT loaders order them: numpy's RandomState(seed).permutation, cut in
    batches."""
    order = np.random.RandomState(loader_seed).permutation(n)
    return [order[i * batch:(i + 1) * batch] for i in range(steps)]
