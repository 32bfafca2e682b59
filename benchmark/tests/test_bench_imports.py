"""Nothing the benchmark runs imports JAX or the JAX package, and the frozen
reference imports nothing of the program: each import's top-level name (the
part before the first dot) is compared whole."""

import ast
import glob
import os

import pytest

from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "split_vae_tpu"}
FILES = sorted(glob.glob(os.path.join(spec.HERE, "**", "*.py"), recursive=True))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value.split(".")[0])
    return names


def test_whole_names_are_compared():
    assert "split_vae_torch" not in FORBIDDEN
    assert {"split_vae_torch"} & FORBIDDEN == set()
    assert "jax" in {"jax.numpy".split(".")[0]}


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [f for f in FILES if f"{os.sep}reference{os.sep}" in f],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "split_vae_torch" not in top_level_imports(path)
    with open(path) as f:
        assert "split_vae_torch" not in f.read()
