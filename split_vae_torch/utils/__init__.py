"""Small helpers (split_vae_tpu/utils). ``utils/download.py`` of the JAX
package is not ported: it needs the network and ``requests``."""
