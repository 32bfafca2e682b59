"""The port's CLI parsers and entry points (split_vae_torch.core.config,
split_vae_torch.cli) against the JAX package's.

For the reference commands, the bare defaults and the reference's flag
quirks, the parsed configs equal the JAX package's field by field. The
``--training_steps 1e5`` case is the one difference: the JAX parser's
int(float()) conversion runs after argparse, which has already refused "1e5"
for a field with an int default; the port parses it.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from split_vae_torch.cli import spair_main, vae_main  # noqa: E402
from split_vae_torch.core import config as port_config  # noqa: E402
from split_vae_tpu.core import config as jax_config  # noqa: E402

CONFIG5 = ["--dataset", "cub_ckb_rot_6", "--z_bg_beta", "1", "--patch_size", "8",
           "--latent_size", "64", "--bg_latent_size", "64", "--local_latent_size", "64",
           "--model", "lg_spair", "-split_z_l", "--z_what_beta", "0.5", "-concat_z_what",
           "-dense_local", "-dense_bg", "--training_steps", "200000"]
CONFIG2 = ["--beta", "30", "--patch_size", "8", "--dataset", "celeba64", "-no_label",
           "--global_latent_dims", "128", "--local_latent_dims", "128", "--batch_size", "64"]
SPAIR_ARGVS = {
    "config5": CONFIG5,
    "defaults": [],
    "allow_growth": ["-allow_growth", "-synthetic_data"],
    "no_fused_render": ["-no_fused_render", "--channel", "1"],
    "framework": ["--eval_interval", "1e3", "--checkpoint_interval", "500", "--resume", "ck",
                  "--platform", "cpu", "-host_data", "-debug_nans", "--profile_dir", "p",
                  "--synthetic_size", "20000", "--seed", "3"],
}
VAE_ARGVS = {
    "config2": CONFIG2,
    "defaults": [],
    "allow_growth": ["-allow_growth", "--model", "lggmvae", "--y_size", "10", "--tau", "0.5"],
    "svhn_labels": ["--dataset", "svhn", "--synthetic_style", "digits", "--alpha", "20"],
}


@pytest.mark.parametrize("name", sorted(SPAIR_ARGVS))
def test_spair_config_equals_jax(name):
    argv = SPAIR_ARGVS[name]
    port = dataclasses.asdict(port_config.parse_spair_args(argv))
    ref = dataclasses.asdict(jax_config.parse_spair_args(argv))
    assert port == ref


@pytest.mark.parametrize("name", sorted(VAE_ARGVS))
def test_vae_config_equals_jax(name):
    argv = VAE_ARGVS[name]
    port = dataclasses.asdict(port_config.parse_vae_args(argv))
    ref = dataclasses.asdict(jax_config.parse_vae_args(argv))
    assert port == ref


def test_no_fused_render_turns_the_fused_render_off():
    cfg = port_config.parse_spair_args(["-no_fused_render"])
    assert cfg.no_fused_render and not cfg.fused_render


@pytest.mark.parametrize("parse", ["parse_spair_args", "parse_vae_args"])
def test_step_counts_parse_through_float(parse):
    port = getattr(port_config, parse)(["--training_steps", "1e5",
                                        "--checkpoint_interval", "2.5e3"])
    assert (port.training_steps, port.checkpoint_interval) == (100_000, 2500)
    assert isinstance(port.training_steps, int)
    # The JAX parser refuses the same flags; given the integers it agrees.
    with pytest.raises(SystemExit):
        getattr(jax_config, parse)(["--training_steps", "1e5"])
    ref = getattr(jax_config, parse)(["--training_steps", "100000",
                                      "--checkpoint_interval", "2500"])
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_classifier_config_equals_jax():
    assert (dataclasses.asdict(port_config.ClassifierConfig())
            == dataclasses.asdict(jax_config.ClassifierConfig()))


def test_spair_main_repeats_runs(monkeypatch):
    calls = []
    monkeypatch.setattr(spair_main, "train_spair", lambda config: calls.append(config))
    spair_main.main(["--runs", "3", "--model", "bg_spair", "-synthetic_data"])
    assert len(calls) == 3 and all(c is calls[0] for c in calls)
    assert calls[0].model == "bg_spair" and calls[0].runs == 3


def test_spair_main_default_single_run(monkeypatch):
    calls = []
    monkeypatch.setattr(spair_main, "train_spair", lambda config: calls.append(config))
    spair_main.main(["-synthetic_data"])
    assert len(calls) == 1 and calls[0].model == "spair"


def test_vae_main_dispatch(monkeypatch):
    calls = []
    monkeypatch.setattr(vae_main, "train_vae", lambda config: calls.append(config))
    vae_main.main(CONFIG2 + ["-synthetic_data"])
    assert len(calls) == 1
    c = calls[0]
    assert (c.model, c.dataset, c.beta, c.patch_size, c.no_label, c.batch_size) == (
        "lgvae", "celeba64", 30.0, 8, True, 64)
