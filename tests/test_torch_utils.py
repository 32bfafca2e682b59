"""The port's dotdict (split_vae_torch/utils/dotdict.py) against the JAX
package's: the same reads, writes, deletes and missing keys."""

import pytest

pytest.importorskip("torch")

from split_vae_torch.utils.dotdict import dotdict as port_dotdict  # noqa: E402
from split_vae_tpu.utils.dotdict import dotdict as jax_dotdict  # noqa: E402


def _exercise(cls):
    d = cls(beta=30.0, model="lgvae")
    seen = [d.beta, d.model, d.missing, d["beta"]]
    d.patch_size = 8
    seen += [d["patch_size"], sorted(d), isinstance(d, dict)]
    del d.model
    seen += [d.model, "model" in d, dict(d)]
    with pytest.raises(KeyError):
        del d.model
    return seen


def test_dotdict_is_the_jax_packages():
    assert _exercise(port_dotdict) == _exercise(jax_dotdict)
    assert port_dotdict(a=1).get("b") is None and port_dotdict().a is None
