"""SVHN probe-classifier pretraining CLI (reference: vae/classifier.py).

    python -m split_vae_torch.cli.classifier_main [--epochs 20] [--seed 0]
        [--data_dir data] [-synthetic_data] [--platform cpu]

Trains on the GPU (``--platform cpu`` for the CPU) and writes the weights to
``models/svhn_classifier_weights*.pt`` in the working directory, the name
``train/probes.py::classifier_weights_path`` keys by dataset flavour.
"""

from __future__ import annotations

import argparse
import sys

from split_vae_torch.core.config import ClassifierConfig
from split_vae_torch.core.runtime import setup_runtime
from split_vae_torch.train.probes import train_classifier


def main(argv=None):
    parser = argparse.ArgumentParser(description="SVHN probe classifier (PyTorch)")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("-synthetic_data", action="store_true")
    parser.add_argument("--platform", type=str, default=None)
    args = parser.parse_args(argv)
    config = ClassifierConfig(seed=args.seed, data_dir=args.data_dir,
                              synthetic_data=args.synthetic_data, epochs=args.epochs,
                              platform=args.platform)
    device = setup_runtime(config.platform)
    print("Config:", config)
    print("Training a classifier")
    return train_classifier(config, epochs=args.epochs, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
