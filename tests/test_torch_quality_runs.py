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


def _write_early(folder, collapsed, skip=None):
    """The curves ``early`` reads: each group's first ``collapsed[group]``
    runs read 26.5 at step 1000 (collapsed), the others 150.0; the run named
    ``skip`` has only a 2000 record."""
    for group, names in port_driver.EARLY_RUNS.items():
        for i, name in enumerate(names):
            value = 26.5 if i < collapsed[group] else 150.0
            step = 2000 if name == skip else 1000
            with open(os.path.join(folder, name + ".metrics.jsonl"), "w") as f:
                f.write(json.dumps({"step": step, "train/z_what_kl_loss": value}) + "\n")
                f.write(json.dumps({"step": step, "test0/z_what_kl_loss": value / 2}) + "\n")


@pytest.mark.parametrize("collapsed,want,p", [
    (dict(port=11, jax_tpu=0, jax_cpu=0), "port lead", 1365 / 167960),
    (dict(port=10, jax_tpu=0, jax_cpu=1), "platform", (3003 * 5 + 1365) / 167960),
    (dict(port=4, jax_tpu=0, jax_cpu=0), "no lead", 1365 / 4845),
    (dict(port=15, jax_tpu=1, jax_cpu=1), "port lead", 10 / 1140),
    (dict(port=9, jax_tpu=1, jax_cpu=1), "no lead", (5005 * 10 + 3003 * 5 + 1365) / 167960),
])
def test_early_follows_the_rule(tmp_path, capsys, collapsed, want, p):
    """15 port runs against 2 TPU and 3 CPU runs of the JAX package, the
    Fisher tail worked by hand (e.g. 11 of 15 against 0 of 5: C(15, 11) /
    C(20, 11)); a collapsing CPU run makes ``platform`` only where the port
    shows no lead and the TPU runs keep z_what."""
    _write_early(str(tmp_path), collapsed)
    out = port_driver.early(str(tmp_path))
    assert out["verdict"] == want
    assert out["counts"] == {"port": [collapsed["port"], 15],
                             "jax_tpu": [collapsed["jax_tpu"], 2],
                             "jax_cpu": [collapsed["jax_cpu"], 3]}
    assert out["p"] == pytest.approx(p, rel=1e-12)
    lo, hi = out["interval"]
    assert lo <= out["share"] == collapsed["port"] / 15 <= hi
    run = out["runs"][port_driver.EARLY_RUNS["port"][0]]
    assert run["test"] == run["value"] / 2
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last[len("EARLY "):])["verdict"] == want


@pytest.mark.parametrize("skip", ["record", "file"])
def test_early_is_undecided_without_a_step_1000_record(tmp_path, capsys, skip):
    """A run that has no step-1000 record, or no curve yet, leaves the
    verdict undecided, whatever the other runs read."""
    missing = port_driver.EARLY_RUNS["jax_cpu"][1]
    _write_early(str(tmp_path), dict(port=15, jax_tpu=0, jax_cpu=0),
                 skip=missing if skip == "record" else None)
    if skip == "file":
        os.remove(os.path.join(str(tmp_path), missing + ".metrics.jsonl"))
    out = port_driver.early(str(tmp_path))
    assert out["verdict"] == "undecided" and "p" not in out
    assert out["runs"][missing]["value"] is None
    assert "no step-1000 record" in capsys.readouterr().out


def test_clopper_pearson_interval():
    """The exact interval's known values: 10 of 15 gives (0.3838, 0.8818);
    0 of n and n of n reach 0 and 1."""
    lo, hi = port_driver.clopper_pearson(10, 15)
    assert (lo, hi) == (pytest.approx(0.38380, abs=1e-5), pytest.approx(0.88176, abs=1e-5))
    assert port_driver.clopper_pearson(0, 15)[0] == 0.0
    assert port_driver.clopper_pearson(15, 15)[1] == 1.0
    assert port_driver.clopper_pearson(0, 15)[1] == pytest.approx(1 - 0.025 ** (1 / 15))


def test_fisher_tail_reads_the_rules_examples():
    """PERF.md's example, 11 of 15 against 0 of 4, gives p = 0.018; the record
    before the runs, 4 of 5 against 0 of 2, gives 1/7."""
    assert port_driver.fisher_greater(11, 15, 0, 4) == pytest.approx(1365 / 75582, rel=1e-12)
    assert port_driver.fisher_greater(4, 5, 0, 2) == pytest.approx(1 / 7, rel=1e-12)
    assert port_driver.fisher_greater(0, 15, 0, 4) == 1.0
