"""Runtime setup (split_vae_tpu/core/runtime.py): the device a run takes.

No ``--platform``, or ``gpu`` / ``cuda``, gives the card, and raises when
CUDA is absent; ``cpu`` gives the CPU. There is no silent move to the CPU.
Either way matmuls and convolutions run in full fp32 (TF32 off). In a
multi-process run the card is this process's, cuda:{local rank}
(``parallel/mesh.py::local_rank``), made the current device.
"""

from __future__ import annotations

from typing import Optional

import torch

from split_vae_torch.models.spair import require_device
from split_vae_torch.train.steps import use_fp32


def setup_runtime(platform: Optional[str] = None, local_rank: int = 0) -> torch.device:
    use_fp32()
    if platform in (None, "gpu", "cuda"):
        device = require_device(f"cuda:{local_rank}")
        torch.cuda.set_device(device)
        return device
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform {platform!r}: the PyTorch port runs on 'gpu' (or 'cuda') "
                     f"or 'cpu'")
