"""Settings of the benchmark's own tests (``python -m pytest benchmark``).

Tests that need a CUDA card carry the ``card`` marker and take the
``card_device`` fixture, which skips them where there is none; nothing is
decided while a module is imported.
"""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


TINY_LIMITS = {"batch_gap": 0.0, "loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 0.05}


def make_tiny_root(tmp: str) -> str:
    """A copy of BENCHMARK.json and benchmark/ with throwaway entries added as
    a later change adds them, as files and entries only: two configurations
    at a tiny size (LG-SPAIR, LGVae), a traffic mix, a cell of each and a
    per-layer metric whose reader always reads 1."""
    shutil.copytree(HERE, os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    here = os.path.join(tmp, "benchmark")

    def put(rel, obj):
        with open(os.path.join(here, rel), "w") as f:
            json.dump(obj, f)

    with open(os.path.join(HERE, "configs", "config5_lgspair.json")) as f:
        spair = json.load(f)
    spair["config"].update(image_size=[24, 24, 3], test_size=[24, 24, 3], object_size=16,
                           latent_size=8, bg_latent_size=8, local_latent_size=8)
    spair["dataset"] = {"count": 48, "shape": [24, 24, 3], "dtype": "float32"}
    put("configs/tiny_spair.json", spair)
    with open(os.path.join(HERE, "configs", "config2_lgvae.json")) as f:
        vae = json.load(f)
    vae["config"].update(global_latent_dims=8, local_latent_dims=8)
    vae["dataset"] = {"count": 48, "shape": [16, 16, 3], "dtype": "uint8"}
    put("configs/tiny_vae.json", vae)
    put("traffic/tiny.json", {"batch_size": 4, "compute_dtype": "float32", "render": "full",
                              "warmup_steps": 1, "profile_steps": 2})
    for cell in ("tiny_spair_cell", "tiny_vae_cell"):
        put(f"workloads/{cell}.json", {"limits": TINY_LIMITS})
    with open(os.path.join(here, "metrics", "tiny_constant.py"), "w") as f:
        f.write('"""A throwaway reader."""\n\n\ndef read(t):\n    return 1.0\n')
    bench["configs"] += [
        {"name": "tiny_spair", "source": "x", "file": "benchmark/configs/tiny_spair.json",
         "reduced": [], "why": "x"},
        {"name": "tiny_vae", "source": "x", "file": "benchmark/configs/tiny_vae.json",
         "reduced": [], "why": "x"}]
    bench["workloads"] += [
        {"name": "tiny_spair_cell", "config": "tiny_spair", "traffic": "tiny", "chips": 1,
         "why": "x"},
        {"name": "tiny_vae_cell", "config": "tiny_vae", "traffic": "tiny", "chips": 1,
         "why": "x"}]
    bench["per_layer"].append({"name": "tiny_constant", "unit": "x", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "train_imgs_per_s"})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("checkout")))
