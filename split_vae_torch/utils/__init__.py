"""Small helpers (split_vae_tpu/utils). ``utils/download.py`` of the JAX
package (``download_file_from_google_drive``) is not ported: it needs the
network and ``requests``."""

from split_vae_torch.utils.dotdict import dotdict
