"""SVHN probe classifier (split_vae_tpu/nn/classifier.py) for the disentanglement probes.

Reference: vae/model.py:325-352. The reference overwrites its bn3/e3
attributes (vae/model.py:332-335), so the *effective* network, the one here,
is three conv blocks (32 k6 s2, 64 k6 s2, 256 k4 s2), each after a BatchNorm,
then three dropout + Dense blocks (256 -> 64 -> 10) at rate 0.25. Names are
the flax tree's (``BatchNorm_0..2``, ``Conv_0..2``, ``Dense_0..2``), the
BatchNorm flax's (``nn/common.py::BatchNorm``: eps 1e-3, momentum 0.99, the
biased batch variance).

In training the three keep masks are drawn from ``noise`` in the order the
dropouts run, as the JAX package draws them from its 'dropout' stream, and
the BatchNorm averages move; out of training neither happens.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from split_vae_torch.core.noise import Noise
from split_vae_torch.nn.common import BatchNorm, Conv, Dense, dropout, flatten

DROPOUT = 0.25


class Classifier(nn.Module):
    """Takes SVHN's 32x32x3 images in [-1, 1], NHWC; gives the 10 class logits
    (the JAX package's ``Classifier(latent_dims=256, target_shape=10)``)."""

    def __init__(self, device=None, dtype=None):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(3, device=device)
        self.Conv_0 = Conv(3, 32, (6, 6), stride=2, device=device, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(32, device=device)
        self.Conv_1 = Conv(32, 64, (6, 6), stride=2, device=device, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(64, device=device)
        self.Conv_2 = Conv(64, 256, (4, 4), stride=2, device=device, dtype=dtype)
        # 32 px after three stride-2 convs
        self.Dense_0 = Dense(4 * 4 * 256, 256, device, dtype=dtype)
        self.Dense_1 = Dense(256, 64, device, dtype=dtype)
        self.Dense_2 = Dense(64, 10, device, dtype=dtype)

    def forward(self, x: torch.Tensor, training: bool = False,
                noise: Optional[Noise] = None) -> torch.Tensor:
        def drop(v):
            if not training:
                return v
            return dropout(v, noise.keep(v.shape, DROPOUT, per_example=True), DROPOUT)

        x = F.relu(self.Conv_0(self.BatchNorm_0(x, training)))
        x = F.relu(self.Conv_1(self.BatchNorm_1(x, training)))
        x = F.relu(self.Conv_2(self.BatchNorm_2(x, training)))
        x = drop(flatten(x))
        x = drop(F.relu(self.Dense_0(x)))
        x = drop(F.relu(self.Dense_1(x)))
        return self.Dense_2(x)
