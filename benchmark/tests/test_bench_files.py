"""Every file of the benchmark loads and keeps to the naming rules; every
name in BENCHMARK.json finds its files."""

import glob
import importlib.util
import json
import os

import pytest

from harness import spec

HERE = spec.HERE
BENCH = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("sub", ["configs", "traffic", "workloads"])
def test_json_files_load(sub):
    files = glob.glob(os.path.join(HERE, sub, "*.json"))
    assert files
    for path in files:
        assert isinstance(spec.load_json(path), (dict, list)), path
        assert spec.NAME.match(os.path.basename(path)[:-5]), path


def test_metric_readers_load():
    for path in glob.glob(os.path.join(HERE, "metrics", "*.py")):
        if os.path.basename(path) == "__init__.py":
            continue
        mod_spec = importlib.util.spec_from_file_location("m", path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        assert callable(module.read), path


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert spec.NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert spec.UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert all(spec.NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    assert len(names) == len(set(names))


def test_every_name_finds_its_files():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
        assert spec.load_json(os.path.join(spec.ROOT, c["file"]))["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert w["config"] in configs
        assert set(cell.own["limits"]) == {"batch_gap", "loss_gap", "grad_gap", "change_gap"}
        assert cell.per_layer and cell.end_to_end
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in BENCH["workloads"]}


def test_a_full_check_fits_its_time():
    """2 + 14 runs a cell at run_seconds + 60 s, 180 s a cell to compile and
    1200 s spare, for the most cells a later change may bring (24)."""
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


def test_the_kernel_names_of_a_roofline_are_the_cells():
    for w in BENCH["workloads"]:
        own = spec.load_cell(w["name"]).own
        for kernels in own.get("rooflines", {}).values():
            assert kernels and all(isinstance(k, str) for k in kernels)
    assert json.dumps(BENCH)
