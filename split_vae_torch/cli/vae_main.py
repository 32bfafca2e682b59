"""SPLIT-VAE training CLI — flag-compatible with the reference vae/main.py.

Example (CelebA 64x64, the reference's README command):
  python -m split_vae_torch.cli.vae_main --beta 30 --patch_size 8 \
      --dataset celeba64 -no_label

Runs on the GPU; ``--platform cpu`` runs on the CPU.
"""

from __future__ import annotations

import sys

from split_vae_torch.core.config import parse_vae_args
from split_vae_torch.train.loop import train_vae


def main(argv=None):
    config = parse_vae_args(argv)
    print("Config:", config)
    print("Training local-global autoencoder")
    train_vae(config)


if __name__ == "__main__":
    main(sys.argv[1:])
