"""The harness end to end on the CPU for the glimpse-local SPAIR model: a
tiny LGGlimpseSPAIR configuration and cell added to a copy of the checkout
(``conftest.make_tiny_root``) as a later change adds them, as files and
entries only. A sound run is correct; a run with each planted fault is not;
the reference's draws are batch-major, and the first half of its
permutation draw orders the patches as the whole does."""

import json
import os

import pytest
import torch

import run
from conftest import TINY_LIMITS, make_tiny_root
from harness import faults
from reference import lgglimpse

SEED = str(2**31 + 29)
CELL = "tiny_glimpse_cell"
SMALL = dict(image_size=[24, 24, 3], test_size=[24, 24, 3], object_size=16, patch_size=4,
             latent_size=8, bg_latent_size=8, local_latent_size=8)


@pytest.fixture(scope="module")
def glimpse_root(tmp_path_factory):
    """A tiny copy with the glimpse configuration's file at 24 px, 16-px
    objects in 4-px patches and latents 8."""
    root = make_tiny_root(str(tmp_path_factory.mktemp("glimpse_checkout")))
    here = os.path.join(root, "benchmark")
    with open(os.path.join(here, "configs", "config5g_lgglimpse.json")) as f:
        glimpse = json.load(f)
    glimpse["config"].update(SMALL)
    glimpse["dataset"] = {"count": 48, "shape": [24, 24, 3], "dtype": "float32"}
    with open(os.path.join(here, "configs", "tiny_glimpse.json"), "w") as f:
        json.dump(glimpse, f)
    with open(os.path.join(here, "workloads", f"{CELL}.json"), "w") as f:
        json.dump({"limits": TINY_LIMITS}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_glimpse", "source": "x",
                             "file": "benchmark/configs/tiny_glimpse.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": CELL, "config": "tiny_glimpse", "traffic": "tiny",
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


def test_a_sound_glimpse_run_is_correct(glimpse_root, capsys):
    result = run_cell(glimpse_root, capsys)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_imgs_per_s", "step_ms_p95", "peak_mem_gib",
                                      "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_in_the_glimpse_step_is_not_correct(glimpse_root, fault, capsys):
    result = run_cell(glimpse_root, capsys, plant=faults.FAULTS[fault])
    assert result["correct"] is False, result["checks"]


def test_the_glimpse_draws_are_batch_major_and_in_order():
    cfg = dict(SMALL, patch_size=8)
    d4 = lgglimpse.draws(cfg, (4, 24, 24, 3), torch.Generator().manual_seed(1))
    d2 = lgglimpse.draws(cfg, (2, 24, 24, 3), torch.Generator().manual_seed(1))
    cells = 4 * 4  # a 2x2 grid of cells an image
    assert [tuple(t.shape) for t in d4] == [(4, 8), (cells, 4), (4, 4), (cells, 8), (cells, 8),
                                            (cells, 1), (cells, 1)]
    assert [t.shape[0] // 2 for t in d4] == [t.shape[0] for t in d2]
    assert d4[2].dtype == torch.float64
    halves = [t[:t.shape[0] // 2] for t in d4]
    assert torch.equal(torch.argsort(halves[2][0]), torch.argsort(d4[2][0]))
