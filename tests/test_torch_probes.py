"""The probes and the VAE loop's probe branch of the port against the JAX
package, on the CPU at a tiny size.

- ``make_vae_probe_step`` of LGVae and LGGMVae on the same forward tuple,
  labels and committed classifier, with the normals the JAX probe draws
  replayed (k_l, then k_g, then fold_in(k_g, 1) for the swapped-y probe):
  every metric equal, or within 1/B where a logit tie flips.
- ``classifier_weights_path`` gives the JAX package's path for each flavour.
- ``train_vae`` end to end for a labelled SVHN run of LGGMVae (config #3's
  flags, narrow latents; also resumed), GMVae and LGVae (config #1): the
  ``meta/classifier_test_acc`` record, and under ``test/`` the cluster
  accuracy (GM families) and the probe columns (LGVae, LGGMVae) at every eval.
"""

import json
import os
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax import serialization  # noqa: E402

from split_vae_torch.core.config import parse_vae_args  # noqa: E402
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.interop.flax_params import load_flax_params  # noqa: E402
from split_vae_torch.models import vae as torch_vae  # noqa: E402
from split_vae_torch.nn.classifier import Classifier as TorchClassifier  # noqa: E402
from split_vae_torch.train import loop  # noqa: E402
from split_vae_torch.train import probes as torch_probes  # noqa: E402
from split_vae_tpu.models.vae import LGGMVae, LGVae  # noqa: E402
from split_vae_tpu.nn.classifier import Classifier as JaxClassifier  # noqa: E402
from split_vae_tpu.train import probes as jax_probes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, HW, LATENT, Y = 8, (32, 32), 8, 5
PROBE_KEYS = {"classifier_recon_acc", "classifier_random_z_l_acc", "classifier_random_z_g_acc",
              "probe_random_z_l_acc_rangefix", "probe_random_z_g_acc_rangefix"}
GM_PROBE_KEYS = {"probe_swapped_y_z_g_acc_rangefix", "probe_swapped_y_transfer_acc_rangefix"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("gm", [False, True], ids=["lgvae", "lggmvae"])
def test_probe_step_matches(gm):
    with open(os.path.join(REPO, "models",
                           "svhn_classifier_weights_synth_digits_8192.msgpack"), "rb") as f:
        cls_vars = serialization.msgpack_restore(f.read())
    if gm:
        model = LGGMVae(LATENT, LATENT, HW, Y, 0.4)
        port = torch_vae.LGGMVae(LATENT, LATENT, HW, Y, 0.4)
        out_type = torch_vae.LGGMVaeOutput
    else:
        model = LGVae(LATENT, LATENT, HW)
        port = torch_vae.LGVae(LATENT, LATENT, HW)
        out_type = torch_vae.LGVaeOutput
    x = jnp.asarray(np.random.RandomState(0).uniform(-1, 1, (B, *HW, 6)).astype(np.float32))
    variables = model.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x)
    out = model.apply(variables, x, rngs={"sample": jax.random.PRNGKey(2)})
    labels = np.eye(10, dtype=np.float32)[np.random.RandomState(1).randint(0, 10, B)]

    rng = jax.random.PRNGKey(5)
    want = jax_probes.make_vae_probe_step(model, JaxClassifier(), gm)(
        variables["params"], cls_vars, rng, out, jnp.asarray(labels))
    k_l, k_g = jax.random.split(rng)
    replay = [np.asarray(jax.random.normal(k_l, out.z_x_hat.shape)),
              np.asarray(jax.random.normal(k_g, out.z_x.shape))]
    if gm:
        replay.append(np.asarray(jax.random.normal(jax.random.fold_in(k_g, 1), out.z_x.shape)))

    load_flax_params(port, jax.tree.map(np.asarray, variables["params"]))
    classifier = load_flax_params(TorchClassifier(), cls_vars)
    t_out = out_type(*[torch.from_numpy(np.asarray(v)) for v in out])
    noise = Noise(torch.Generator(), replay)
    got = torch_probes.make_vae_probe_step(port, classifier, gm)(
        t_out, torch.from_numpy(labels), noise)
    assert noise.exhausted()
    assert set(got) == set(want) == PROBE_KEYS | (GM_PROBE_KEYS if gm else set())
    for k in want:
        assert got[k].dim() == 0 and not got[k].requires_grad
        assert abs(float(got[k]) - float(want[k])) <= 1.0 / B + 1e-6, k


@pytest.mark.parametrize("flags", [
    dict(synthetic_data=True, synthetic_style="digits", synthetic_size=8192),
    dict(synthetic_data=True, synthetic_style="digits", synthetic_size=0),
    dict(synthetic_data=True, synthetic_style=None, synthetic_size=512),
    dict(synthetic_data=False),
], ids=["digits8192", "digits_default", "blobs", "real"])
def test_classifier_weights_path_is_the_jax_packages(flags):
    cfg = types.SimpleNamespace(**flags)
    assert torch_probes.classifier_weights_path(cfg) == jax_probes.classifier_weights_path(cfg)


VAE_ARGV = ["--platform", "cpu", "-synthetic_data", "--synthetic_style", "digits",
            "--synthetic_size", "32", "--dataset", "svhn", "--batch_size", "16",
            "--global_latent_dims", "8", "--local_latent_dims", "8", "--y_size", str(Y),
            "--eval_interval", "2", "--checkpoint_interval", "2"]
CONFIG3_FLAGS = ["--model", "lggmvae", "--beta", "40", "--alpha", "40", "--patch_size", "4"]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("flags, probes, cluster", [
    (CONFIG3_FLAGS, PROBE_KEYS | GM_PROBE_KEYS, True),
    (["--model", "gmvae", "--patch_size", "4"], set(), True),
    (["--model", "lgvae", "--beta", "40", "--patch_size", "4"], PROBE_KEYS, False),
], ids=["lggmvae", "gmvae", "lgvae"])
def test_train_vae_labelled_svhn_runs_the_probes(tmp_path, monkeypatch, capsys, flags, probes,
                                                 cluster):
    monkeypatch.chdir(tmp_path)
    state, run_dir = loop.train_vae(parse_vae_args(VAE_ARGV + flags + ["--training_steps", "4"]))
    assert state.step == 5
    out = capsys.readouterr().out
    assert "Classifier model not found, training a new classifier" in out
    assert os.path.isfile(os.path.join("models", "svhn_classifier_weights_synth_digits_32.pt"))
    records = _records(run_dir)
    (meta,) = [r for r in records if "meta/classifier_test_acc" in r]
    assert meta["step"] == 0 and 0.0 <= meta["meta/classifier_test_acc"] <= 1.0
    assert f"Classifier test acc: {meta['meta/classifier_test_acc']:.4f}" in out
    tests = [r for r in records if any(k.startswith("test/") for k in r)]
    assert [r["step"] for r in tests] == [2, 4]
    for r in tests:
        keys = {k[len("test/"):] for k in r if k.startswith("test/")}
        assert probes <= keys and not (PROBE_KEYS | GM_PROBE_KEYS) - probes & keys
        assert ("classifier_cluster_acc" in keys) == cluster
        assert np.isfinite([v for k, v in r.items() if k != "step"]).all()
    for r in records:
        assert r.get("train/notfinite_updates", 0.0) == 0.0
    if flags is CONFIG3_FLAGS:
        ckpt_dir = os.path.join(run_dir, "checkpoints")
        resumed, run_dir2 = loop.train_vae(parse_vae_args(
            VAE_ARGV + flags + ["--training_steps", "6", "--resume", ckpt_dir]))
        out = capsys.readouterr().out
        assert f"Resumed from {ckpt_dir} at step 4" in out and resumed.step == 7
        assert "training a new classifier" not in out  # the .pt written above is read
        assert [r["step"] for r in _records(run_dir2) if "test/classifier_cluster_acc" in r] == [6]
