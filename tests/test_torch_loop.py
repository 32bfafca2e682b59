"""The port's training loops (split_vae_torch.train.loop) on the CPU at a tiny
size: the JSONL records fall at the steps and under the prefixes of the JAX
loop's schedule (``while step <= total_steps``: records at every
eval_interval and at total_steps, checkpoints likewise), each prefix holding
the keys of the port's train or eval step (which the step tests hold to the
JAX package's) plus ``imgs_per_sec`` under ``train/``; the checkpoints, the
final weights at models/<run>.pt and the resume, which continues from the
checkpoint's step. What is not ported yet raises, naming its ROADMAP item.
Data parallelism in several processes is held in ``tests/test_torch_parallel.py``.
The PNG artifacts of each eval are held in ``tests/test_torch_viz.py``.

The test sweeps of the SPAIR run read 16 images a split (the synthetic
default is 256), to keep the CPU run short.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from split_vae_torch.core.config import parse_spair_args, parse_vae_args  # noqa: E402
import copy  # noqa: E402

from split_vae_torch.core.state import create_train_state  # noqa: E402
from split_vae_torch.data.multicub import get_multicub  # noqa: E402
from split_vae_torch.train import loop  # noqa: E402
from split_vae_torch.train.optim import spair_optimizer, vae_optimizer  # noqa: E402
from split_vae_torch.train.steps import (  # noqa: E402
    make_spair_eval_step,
    make_spair_train_step,
    make_vae_eval_step,
    make_vae_train_step,
)

SPAIR_ARGV = ["--platform", "cpu", "-synthetic_data", "--synthetic_size", "24",
              "--dataset", "cub_ckb_rot_6", "--model", "lg_spair", "-split_z_l",
              "-concat_z_what", "--latent_size", "8", "--bg_latent_size", "8",
              "--local_latent_size", "8", "--patch_size", "8", "--object_size", "16",
              "--batch_size", "8", "--eval_interval", "3", "--checkpoint_interval", "3",
              "--log_every", "2"]
VAE_ARGV = ["--platform", "cpu", "-synthetic_data", "--synthetic_size", "32",
            "--dataset", "svhn", "-no_label", "--beta", "30", "--patch_size", "4",
            "--global_latent_dims", "8", "--local_latent_dims", "8", "--batch_size", "16",
            "--eval_interval", "3", "--checkpoint_interval", "3"]



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small CPU steps, which
    several test processes side by side would otherwise slow by contending
    for every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    # models/ weights are written relative to the working directory, as in the
    # reference; data/ and output/ are the configs' defaults.
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(loop, "get_multicub", lambda config: get_multicub(config, n_eval=16))


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _by_prefix(records, prefix):
    """{step: the record's keys under prefix, without it}."""
    return {r["step"]: {k[len(prefix):] for k in r if k.startswith(prefix)}
            for r in records if any(k.startswith(prefix) for k in r)}


def _check_run(run_dir, steps, expect_keys, ckpts):
    records = _records(run_dir)
    for prefix, keys in expect_keys.items():
        got = _by_prefix(records, prefix)
        assert sorted(got) == steps, prefix
        assert all(k == keys for k in got.values()), (prefix, got, keys)
    for r in records:
        assert np.isfinite([v for k, v in r.items() if k != "step"]).all(), r
        assert r.get("train/notfinite_updates", 0.0) == 0.0
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ckpts
    assert os.path.isfile(os.path.join("models", os.path.basename(run_dir) + ".pt"))


def test_train_spair_schedule_checkpoints_and_resume(capsys):
    state, run_dir = loop.train_spair(parse_spair_args(SPAIR_ARGV + ["--training_steps", "6"]))
    assert state.step == 7  # the JAX loop's extra step after the last eval
    cfg = parse_spair_args(SPAIR_ARGV)
    ev = make_spair_eval_step(cfg, state.model)
    batch = torch.rand((8, 48, 48, 3), generator=torch.Generator().manual_seed(0))
    _, eval_metrics, _ = ev(torch.Generator().manual_seed(0), batch, torch.ones(8))
    fresh = create_train_state(copy.deepcopy(state.model), spair_optimizer(1e-4))
    _, train_metrics = make_spair_train_step(cfg)(fresh, batch)
    train_keys = set(train_metrics) | {"imgs_per_sec"}
    keys = {"train/": train_keys, "test0/": set(eval_metrics), "test1/": set(eval_metrics)}
    _check_run(run_dir, [3, 6], keys, ["checkpoint_3.pt", "checkpoint_6.pt"])
    assert "[step 2] total_loss:" in capsys.readouterr().out

    ckpt_dir = os.path.join(run_dir, "checkpoints")
    resumed, run_dir2 = loop.train_spair(parse_spair_args(
        SPAIR_ARGV + ["--training_steps", "9", "--resume", ckpt_dir]))
    assert f"Resumed from {ckpt_dir} at step 6" in capsys.readouterr().out
    assert resumed.step == 10 and run_dir2 != run_dir
    _check_run(run_dir2, [9], keys, ["checkpoint_9.pt"])


@pytest.mark.parametrize("host_data", [False, True], ids=["resident", "streamed"])
def test_train_vae_schedule_checkpoints_and_resume(capsys, host_data):
    argv = VAE_ARGV + (["-host_data"] if host_data else [])
    state, run_dir = loop.train_vae(parse_vae_args(argv + ["--training_steps", "6"]))
    assert state.step == 7
    cfg = parse_vae_args(argv)
    _, eval_metrics, _ = make_vae_eval_step(cfg, state.model)(
        torch.Generator().manual_seed(0), torch.zeros((4, 32, 32, 3), dtype=torch.uint8))
    fresh = create_train_state(copy.deepcopy(state.model), vae_optimizer(1e-4))
    _, train_metrics = make_vae_train_step(cfg)(fresh, torch.zeros((4, 32, 32, 3),
                                                                   dtype=torch.uint8))
    keys = {"train/": set(train_metrics) | {"imgs_per_sec"}, "test/": set(eval_metrics)}
    _check_run(run_dir, [3, 6], keys, ["checkpoint_3.pt", "checkpoint_6.pt"])

    ckpt_dir = os.path.join(run_dir, "checkpoints")
    resumed, run_dir2 = loop.train_vae(parse_vae_args(
        argv + ["--training_steps", "9", "--resume", ckpt_dir]))
    assert f"Resumed from {ckpt_dir} at step 6" in capsys.readouterr().out
    assert resumed.step == 10
    _check_run(run_dir2, [9], keys, ["checkpoint_9.pt"])


@pytest.mark.parametrize("extra, item", [
    (["--num_model_shards", "2", "-no_label"], "A8"),
    (["--num_data_shards", "2", "-no_label"], "A8"),
    (["--num_processes", "2", "-no_label"], "A8"),
])
def test_unported_options_raise(extra, item, monkeypatch):
    """Data and tensor parallelism are ported (tests/test_torch_parallel.py,
    tests/test_torch_tensor_parallel.py); a request of them that this one
    process cannot meet (a model count that does not divide its world of 1,
    a data count other than that world, or 2 processes with neither
    --coordinator nor torchrun's address) is refused with a ValueError naming
    their ROADMAP item."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--platform", "cpu", "-synthetic_data", "--synthetic_size", "8",
            "--training_steps", "1", "--global_latent_dims", "4", "--local_latent_dims", "4"]
    with pytest.raises(ValueError, match=item):
        loop.train_vae(parse_vae_args(argv + extra))


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train_spair(parse_spair_args(["-synthetic_data", "--training_steps", "1"]))
    with pytest.raises(ValueError, match="tpu"):
        loop.train_vae(parse_vae_args(["--platform", "tpu", "-no_label"]))


def test_run_dirs_and_records_are_the_jax_packages(tmp_path):
    from split_vae_torch.core import logging as port_logging
    from split_vae_tpu.core import logging as jax_logging

    dirs = [port_logging.make_run_dir(str(tmp_path)) for _ in range(3)]
    assert len(set(dirs)) == 3 and all(os.path.isdir(d) for d in dirs)
    metrics = {"total_loss": torch.tensor(3.5), "count_acc": 0.25}
    for module, run_dir in ((port_logging, dirs[0]), (jax_logging, dirs[1])):
        logger = module.RunLogger(run_dir)
        logger.log(7, metrics if module is port_logging else
                   {k: float(v) for k, v in metrics.items()}, prefix="test0/")
        logger.close()
    mine, theirs = (_records(d)[0] for d in dirs[:2])
    assert mine.keys() == theirs.keys()
    assert {k: v for k, v in mine.items() if k != "time"} == \
        {k: v for k, v in theirs.items() if k != "time"}


def test_profile_and_timer(tmp_path):
    from split_vae_torch.core.logging import StepTimer, maybe_profile

    with maybe_profile(str(tmp_path), 100):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "step_100" / "trace.json") > 0
    with maybe_profile(None, 100):
        pass
    timer = StepTimer()
    timer.add(64)
    assert timer.rate(sync_value=torch.zeros(())) > 0
