"""The harness end to end on the CPU for the Gaussian-mixture family: a tiny
LGGMVae configuration and cell added to a copy of the checkout
(``conftest.make_tiny_root``) as a later change adds them, as files and
entries only. A sound run is correct; a run with each planted fault is not;
the reference's draws are per example."""

import json
import os

import pytest
import torch

import run
from conftest import TINY_LIMITS, make_tiny_root
from harness import faults
from reference import lggmvae

SEED = str(2**31 + 13)
CELL = "tiny_gm_cell"


@pytest.fixture(scope="module")
def gm_root(tmp_path_factory):
    """A tiny copy with config #4's file at 16x16, latents 8 and y_size 5."""
    root = make_tiny_root(str(tmp_path_factory.mktemp("gm_checkout")))
    here = os.path.join(root, "benchmark")
    with open(os.path.join(here, "configs", "config4_lggmvae.json")) as f:
        gm = json.load(f)
    gm["config"].update(global_latent_dims=8, local_latent_dims=8, y_size=5)
    gm["dataset"] = {"count": 48, "shape": [16, 16, 3], "dtype": "uint8"}
    with open(os.path.join(here, "configs", "tiny_gm.json"), "w") as f:
        json.dump(gm, f)
    with open(os.path.join(here, "workloads", f"{CELL}.json"), "w") as f:
        json.dump({"limits": TINY_LIMITS}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_gm", "source": "x",
                             "file": "benchmark/configs/tiny_gm.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": CELL, "config": "tiny_gm", "traffic": "tiny",
                               "chips": 1, "why": "x"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def run_cell(root, capsys, plant=None):
    torch.manual_seed(0)
    rc = run.main(["--workload", CELL, "--seed", SEED, "--seconds", "0.5", "--trace", "0"],
                  device="cpu", root=root, plant=plant)
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_a_sound_gm_run_is_correct(gm_root, capsys):
    result = run_cell(gm_root, capsys)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_imgs_per_s", "step_ms_p95", "peak_mem_gib",
                                      "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_in_the_gm_step_is_not_correct(gm_root, fault, capsys):
    result = run_cell(gm_root, capsys, plant=faults.FAULTS[fault])
    assert result["correct"] is False, result["checks"]


def test_the_gm_draws_are_per_example_and_in_order():
    cfg = {"patch_size": 8, "global_latent_dims": 8, "local_latent_dims": 6, "y_size": 5}
    d4 = lggmvae.draws(cfg, (4, 16, 24, 3), torch.Generator().manual_seed(1))
    d2 = lggmvae.draws(cfg, (2, 16, 24, 3), torch.Generator().manual_seed(1))
    assert [tuple(t.shape) for t in d4] == [(4, 6), (4, 5), (4, 8), (4, 6), (4, 1024),
                                            (4, 2 * 3 * 128)]
    assert [t.shape[0] // 2 for t in d4] == [t.shape[0] for t in d2]
    assert d4[4].dtype == d4[5].dtype == torch.bool
    assert 0.7 < float(d4[5].float().mean()) < 0.9
