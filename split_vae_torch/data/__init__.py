"""Datasets (SVHN, CelebA, MultiCUB), the batch index stream and the device batches."""

from split_vae_torch.data.celeba import get_celeba
from split_vae_torch.data.loader import ArrayDataset, device_prefetch, iterate_batches
from split_vae_torch.data.multicub import get_multicub
from split_vae_torch.data.svhn import get_svhn

__all__ = ["ArrayDataset", "device_prefetch", "get_celeba", "get_multicub", "get_svhn",
           "get_vae_dataset", "iterate_batches"]


def get_vae_dataset(config):
    """Dispatch mirroring vae/data.py:11-21."""
    name = config.dataset.upper()
    if name == "SVHN":
        return get_svhn(config, extra=True)
    if name == "SVHN_NO_EXTRA":
        return get_svhn(config, extra=False)
    if name in ("CELEBA64", "CELEBA128"):
        return get_celeba(config, size=64 if name == "CELEBA64" else 128)
    raise NotImplementedError(f"Dataset doesn't exist: {config.dataset}")
