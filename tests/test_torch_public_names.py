"""The port's subpackages export the JAX package's public names, and the
one-image scramble forms equal the JAX ones.

- Every name that ``split_vae_tpu/{ops,nn,models,core,utils,parallel,data}``
  export in their ``__init__`` imports from the port's subpackage of the same
  name, except those without a counterpart: ``batch_sharding``,
  ``replicated_sharding`` and ``shard_batch`` (``jax.sharding`` objects) and
  ``download_file_from_google_drive`` (the network).
- ``patch_scramble`` and ``mix_scramble`` against the JAX forms
  (split_vae_tpu/ops/patches.py:37-50, 89-94) on the same image, the JAX
  keys' permutation (and size index) replayed into the port's ``Noise``.
"""

import ast
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.ops import patches as port_patches  # noqa: E402
from split_vae_tpu.ops import patches as jax_patches  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("ops", "nn", "models", "core", "utils", "parallel", "data")
NO_COUNTERPART = {"batch_sharding", "replicated_sharding", "shard_batch",
                  "download_file_from_google_drive"}


def jax_exports(sub):
    """The names ``split_vae_tpu/<sub>/__init__.py`` imports or defines."""
    with open(os.path.join(REPO, "split_vae_tpu", sub, "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
    return names


EXPORTS = [(sub, name) for sub in SUBPACKAGES for name in jax_exports(sub)]


@pytest.mark.parametrize("sub, name", EXPORTS, ids=[f"{s}.{n}" for s, n in EXPORTS])
def test_each_jax_export_imports_from_the_port(sub, name):
    module = importlib.import_module(f"split_vae_torch.{sub}")
    if name in NO_COUNTERPART:
        assert not hasattr(module, name)
        assert name in module.__doc__  # the docstring says why
        return
    assert callable(getattr(module, name)), f"split_vae_torch.{sub}.{name}"


@pytest.mark.parametrize("size", [1, 2, 4])
def test_patch_scramble_equals_the_jax_form(size):
    x = np.random.RandomState(size).rand(8, 8, 3).astype(np.float32)
    key = jax.random.PRNGKey(size)
    want = np.asarray(jax_patches.patch_scramble(key, jnp.asarray(x), size))
    perm = np.array(jax.random.permutation(key, (8 // size) ** 2))
    noise = Noise(torch.Generator(), [torch.from_numpy(perm)])
    got = port_patches.patch_scramble(torch.from_numpy(x), size, noise)
    assert noise.exhausted()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_mix_scramble_equals_the_jax_form(seed):
    x = np.random.RandomState(seed).rand(16, 16, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_patches.mix_scramble(key, jnp.asarray(x)))
    k_size, k_perm = jax.random.split(key)
    idx = int(jax.random.randint(k_size, (), 0, len(jax_patches.MIX_SIZES)))
    size = jax_patches.MIX_SIZES[idx]
    perm = np.array(jax.random.permutation(k_perm, (16 // size) ** 2))
    noise = Noise(torch.Generator(), [torch.tensor(idx), torch.from_numpy(perm)])
    got = port_patches.mix_scramble(torch.from_numpy(x), noise)
    assert noise.exhausted()
    np.testing.assert_array_equal(got.numpy(), want)


def test_drawn_scrambles_move_whole_patches():
    x = torch.arange(64.0).reshape(8, 8, 1)
    out = port_patches.patch_scramble(x, 2, Noise(torch.Generator().manual_seed(0)))
    blocks = {tuple(x[i:i + 2, j:j + 2, 0].reshape(-1).tolist())
              for i in range(0, 8, 2) for j in range(0, 8, 2)}
    assert {tuple(out[i:i + 2, j:j + 2, 0].reshape(-1).tolist())
            for i in range(0, 8, 2) for j in range(0, 8, 2)} == blocks
    mixed = port_patches.mix_scramble(x, Noise(torch.Generator().manual_seed(1)))
    assert sorted(mixed.reshape(-1).tolist()) == x.reshape(-1).tolist()
