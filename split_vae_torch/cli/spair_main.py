"""SPLIT-SPAIR training CLI — flag-compatible with the reference spair/main.py.

Example (Multi-Bird-Hard, README.md:96-107):
  python -m split_vae_torch.cli.spair_main --dataset cub_ckb_rot_6 --z_bg_beta 1 \
      --patch_size 8 --latent_size 64 --bg_latent_size 64 --local_latent_size 64 \
      --model lg_spair -split_z_l --z_what_beta 0.5 -concat_z_what -dense_local \
      -dense_bg --training_steps 200000

Runs on the GPU; ``--platform cpu`` runs on the CPU.
"""

from __future__ import annotations

import sys

from split_vae_torch.core.config import parse_spair_args
from split_vae_torch.train.loop import train_spair


def main(argv=None):
    config = parse_spair_args(argv)
    print("Config:", config)
    for run in range(config.runs):  # --runs repeats training (spair/main.py:95)
        print("Creating model...")
        print("Training SPAIR")
        train_spair(config)


if __name__ == "__main__":
    main(sys.argv[1:])
