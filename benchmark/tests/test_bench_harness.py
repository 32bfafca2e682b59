"""The harness end to end on the CPU at a tiny size, from a copy of the
checkout with throwaway entries (``conftest.make_tiny_root``): a sound run is
correct, a run with each planted fault is not, a new per-layer reader is
found by its name, and a run on a machine without a card gives no result."""

import json
import os
import subprocess
import sys

import pytest
import torch

import run
from harness import faults

SEED = str(2**31 + 11)


def run_cell(root, cell, trace=0, plant=None, capsys=None):
    torch.manual_seed(0)
    rc = run.main(["--workload", cell, "--seed", SEED, "--seconds", "0.5", "--trace", str(trace)],
                  device="cpu", root=root, plant=plant)
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", ["tiny_spair_cell", "tiny_vae_cell"])
def test_a_sound_run_is_correct(tiny_root, cell, capsys):
    result, err = run_cell(tiny_root, cell, capsys=capsys)
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_imgs_per_s", "step_ms_p95", "peak_mem_gib",
                                      "setup_s"}
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check change_gap")
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_a_traced_run_reads_the_new_metric(tiny_root, capsys):
    result, _ = run_cell(tiny_root, "tiny_vae_cell", trace=1, capsys=capsys)
    assert result["correct"] is True
    # No device on the CPU: the device readers find nothing; the throwaway one reads 1.
    assert result["metrics"] == {"tiny_constant": {"value": 1.0, "unit": "x"}}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", ["tiny_spair_cell", "tiny_vae_cell"])
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault, capsys):
    result, _ = run_cell(tiny_root, cell, plant=faults.FAULTS[fault], capsys=capsys)
    assert result["correct"] is False, result["checks"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA card (this machine, or a copy holding only the
    benchmark's files) the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    here = os.path.dirname(run.__file__)
    proc = subprocess.run([sys.executable, os.path.join(here, "run.py"), "--workload",
                           "c5_lgspair_fp32_b256", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
