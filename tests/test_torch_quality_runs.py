"""quality_runs_torch.py against the JAX package's tools/quality_runs.py.

Each driver's run is captured where it would start training (the loops'
``train_spair`` / ``train_vae`` patched), so the configurations and the bound
dataset knobs are compared without training: the two configs are equal
field for field (both packages' configs have the same fields), for each
seed, and the SPAIR runs' ``get_multicub`` takes 20,000 canvases,
512-image test splits and the sprite contrast in both. ``verdict`` applies
PERF.md's rule to curves written here.
"""

import dataclasses
import json
import os

import pytest

pytest.importorskip("torch")

import quality_runs_torch as port_driver  # noqa: E402
import split_vae_torch.data.multicub as port_multicub  # noqa: E402
import split_vae_torch.train.loop as port_loop  # noqa: E402
import split_vae_tpu.train.loop as jax_loop  # noqa: E402
from tools import quality_runs as jax_driver  # noqa: E402


def _capture(monkeypatch, module, name):
    seen = {}

    def train(config, max_steps=None):
        seen["config"] = config
        seen["get_multicub"] = getattr(module, "get_multicub", None)
        return None, "run"

    monkeypatch.setattr(module, name, train)
    monkeypatch.setattr(module, "get_multicub", getattr(module, "get_multicub", None),
                        raising=False)
    return seen


def _fields(config):
    return {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}


def _same_fields(want, got):
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spair_run_is_the_jax_drivers(monkeypatch, seed):
    jax_seen = _capture(monkeypatch, jax_loop, "train_spair")
    port_seen = _capture(monkeypatch, port_loop, "train_spair")
    jax_driver.run_spair(30_000, 256, "out", z_what_beta=0.1, seed=seed)
    config = port_driver.spair_config(30_000, 256, "out", z_what_beta=0.1, seed=seed)
    port_driver.run_spair(config)
    _same_fields(jax_seen["config"], port_seen["config"])
    want, got = jax_seen["get_multicub"], port_seen["get_multicub"]
    assert got.keywords == want.keywords == dict(n_train=20_000, n_eval=512,
                                                 sprite_min_color=60.0)


@pytest.mark.parametrize("style", ["digits", "blobs"])
def test_gmvae_run_is_the_jax_drivers(monkeypatch, style):
    jax_seen = _capture(monkeypatch, jax_loop, "train_vae")
    port_seen = _capture(monkeypatch, port_loop, "train_vae")
    jax_driver.run_gmvae(30_000, 64, "out", style=style)
    port_driver.run_vae(port_driver.vae_config(30_000, 64, "out", style=style))
    _same_fields(jax_seen["config"], port_seen["config"])


def test_main_prints_the_quality_result(tmp_path, monkeypatch, capsys):
    records = [{"step": 1000, "train/total_loss": 7000.0},
               {"step": 1000, "test0/count_acc": 0.25, "test0/MAE test": 1.5},
               {"step": 1000, "test1/count_acc": 0.125}]

    def train(config, max_steps=None):
        assert config.seed == 2 and config.z_what_beta == 0.1 and config.platform == "cpu"
        run_dir = tmp_path / "run"
        run_dir.mkdir()
        (run_dir / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
        return None, str(run_dir)

    monkeypatch.setattr(port_loop, "train_spair", train)
    monkeypatch.setattr(port_loop, "get_multicub", port_loop.get_multicub)
    summary = port_driver.main(["spair", "--z_what_beta", "0.1", "--seed", "2",
                                "--platform", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("QUALITY_RESULT ") and json.loads(line[15:]) == json.loads(
        json.dumps(summary))
    assert summary["final"] == {"test0/count_acc": (1000, 0.25), "test0/MAE test": (1000, 1.5),
                                "test1/count_acc": (1000, 0.125)}


def test_data_only_makes_the_canvases_and_trains_nothing(monkeypatch):
    made = []

    def get_multicub(config, **kw):
        made.append((config.seed, kw))

    monkeypatch.setattr(port_multicub, "get_multicub", get_multicub)
    monkeypatch.setattr(port_loop, "get_multicub", port_loop.get_multicub)
    monkeypatch.setattr(port_loop, "train_spair", lambda *a, **k: pytest.fail("trained"))
    assert port_driver.main(["spair", "--data_only"]) is None
    assert made == [(0, dict(n_train=20_000, n_eval=512, sprite_min_color=60.0))]


def test_driver_sits_at_the_repo_root():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(os.path.abspath(port_driver.__file__)) == root


def _write_curves(folder, port_acc, jax_acc, loss=7000.0, port_steps=(10_000, 20_000, 30_000)):
    """The curves ``verdict`` reads, with ``test0/count_acc`` (config #5) and
    ``test/classifier_cluster_acc`` (config #3) at ``port_steps`` in the
    port's curves and every 5k steps from 10k in JAX's."""
    def write(name, acc, steps=(10_000, 15_000, 20_000, 25_000, 30_000)):
        with open(os.path.join(folder, name + ".metrics.jsonl"), "w") as f:
            for step in steps:
                for record in ({"train/total_loss": loss},
                               {"test0/count_acc": acc, "test1/count_acc": acc},
                               {"test/classifier_cluster_acc": acc}):
                    f.write(json.dumps({"step": step, **record}) + "\n")

    for port_names, jax_names, _, _ in port_driver.VERDICT_RUNS.values():
        for name, acc in zip(port_names, port_acc):
            write(name, acc, port_steps)
        for name in jax_names:
            write(name, jax_acc)


@pytest.mark.parametrize("jax_acc,want", [(0.5, "no fault"), (0.62, "no fault"),
                                          (0.9, "fault")])
def test_verdict_follows_the_rule(tmp_path, capsys, jax_acc, want):
    """Port seeds at 0.4, 0.5, 0.6 (mean 0.5, sd 0.1): 0.5 lies in the
    interval, 0.62 only in the band (0.3, 0.7), 0.9 outside both."""
    _write_curves(str(tmp_path), [0.4, 0.5, 0.6], jax_acc)
    out = port_driver.verdict(str(tmp_path))
    assert [v["verdict"] for v in out.values()] == [want, want]
    row = out["config #5 (--z_what_beta 0.1)"]["rows"][("test0/count_acc", 20_000)]
    assert row["port"] == [0.4, 0.5, 0.6] and row["sd"] == pytest.approx(0.1)
    assert ("train/total_loss", 30_000) in out["config #5 (--z_what_beta 0.1)"]["rows"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("VERDICT ")


@pytest.mark.parametrize("jax_acc", [0.5, 0.9])
def test_verdict_is_undecided_without_a_plateau_reading(tmp_path, capsys, jax_acc):
    """Port runs that stopped at 25k have no 30k reading: the verdict waits for
    it, whether the 20k reading lies inside or outside, and the shortfall
    shows as a reading of its own."""
    _write_curves(str(tmp_path), [0.4, 0.5, 0.6], jax_acc, port_steps=(10_000, 20_000, 25_000))
    out = port_driver.verdict(str(tmp_path))
    assert [v["verdict"] for v in out.values()] == ["undecided", "undecided"]
    rows = out["config #5 (--z_what_beta 0.1)"]["rows"]
    assert rows[("test0/count_acc", 30_000)] == {"missing": 3}
    assert rows[("test0/count_acc", 25_000)]["port"] == [0.4, 0.5, 0.6]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last[len("VERDICT "):]) == {c: "undecided" for c in out}
