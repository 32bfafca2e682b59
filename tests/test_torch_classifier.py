"""The SVHN probe classifier of the port against the JAX package: the
committed flax weights read into both packages give the same logits (1e-4);
a training-mode forward on replayed dropout masks gives the same logits and
the same new ``batch_stats`` (1e-5 in float64 on both sides; 1e-4 in
float32); the variables tree converts both ways;
the flax BatchNorm rule (biased batch variance) that ``nn.BatchNorm2d`` does
not follow; ``load_or_train_classifier``'s order of files; and
``cli/classifier_main.py`` on the CPU.
"""

import os
import re
import shutil

import pytest

torch = pytest.importorskip("torch")

import flax.linen as flax_nn  # noqa: E402
import split_vae_tpu.nn.common as jax_common  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax import serialization  # noqa: E402

from split_vae_torch.cli import classifier_main  # noqa: E402
from split_vae_torch.core.checkpoint import load_weights, save_weights  # noqa: E402
from split_vae_torch.core.config import VaeConfig  # noqa: E402
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.data.svhn import synthetic_svhn_digits  # noqa: E402
from split_vae_torch.interop.flax_params import (  # noqa: E402
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)
from split_vae_torch.nn.classifier import Classifier as TorchClassifier  # noqa: E402
from split_vae_torch.nn.common import BatchNorm  # noqa: E402
from split_vae_torch.train import probes  # noqa: E402
from split_vae_torch.train.steps import normalize_images  # noqa: E402
from split_vae_tpu.nn.classifier import Classifier as JaxClassifier  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = ["svhn_classifier_weights_synth_digits_8192.msgpack", "svhn_classifier_weights.msgpack"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(name):
    with open(os.path.join(REPO, "models", name), "rb") as f:
        return serialization.msgpack_restore(f.read())


def _digits(n=16):
    _, _, x, y = synthetic_svhn_digits(n_train=0, n_test=n, seed=3)
    return np.asarray(normalize_images(torch.from_numpy(x), "tanh")), np.eye(10)[y - 1]


@pytest.mark.parametrize("name", WEIGHTS)
def test_committed_weights_give_the_same_logits(name):
    tree = _tree(name)
    x, _ = _digits()
    want = np.asarray(JaxClassifier(latent_dims=256, target_shape=10).apply(tree, jnp.asarray(x)))
    port = load_weights(os.path.join(REPO, "models", name), TorchClassifier())
    got = port(torch.from_numpy(x), False).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def _jax_training_forward(tree, x, masks, monkeypatch, dtype):
    """The JAX classifier in training mode on the given keep masks, in ``dtype``."""
    masks = list(masks)

    def dropout(module, inputs, deterministic=None, rng=None):
        if deterministic:
            return inputs
        return jnp.where(masks.pop(0), inputs / (1.0 - module.rate), 0.0)

    with monkeypatch.context() as mp, jax.enable_x64(dtype == np.float64):
        mp.setattr(flax_nn.Dropout, "__call__", dropout)
        mp.setattr(jax_common, "_ACTIVATION_DTYPE", jnp.dtype(dtype))
        variables = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        logits, updates = JaxClassifier(latent_dims=256, target_shape=10).apply(
            variables, jnp.asarray(x, dtype), True, mutable=["batch_stats"])
        assert not masks
        return np.asarray(logits), jax.tree.map(np.asarray, updates["batch_stats"])


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-5), (np.float32, 1e-4)],
                         ids=["float64", "float32"])
def test_training_forward_matches_with_its_batch_stats(monkeypatch, dtype, tol):
    """The JAX package's float32 batch variance (E[x^2] - E[x]^2 as XLA sums it
    on the CPU) lies 6.0e-7 from the float64 one, its logits 6.2e-5; the
    port's 2.8e-8 and 5.1e-6. So 1e-5 is held in float64, 1e-4 in float32."""
    tree = _tree(WEIGHTS[0])
    x, _ = _digits()
    masks = []
    orig = flax_nn.Dropout.__call__

    def record(module, inputs, deterministic=None, rng=None):
        if not deterministic:
            rng = module.make_rng(module.rng_collection) if rng is None else rng
            masks.append(np.array(jax.random.bernoulli(rng, 1.0 - module.rate, inputs.shape)))
        return orig(module, inputs, deterministic, rng)

    with monkeypatch.context() as mp:
        mp.setattr(flax_nn.Dropout, "__call__", record)
        JaxClassifier(latent_dims=256, target_shape=10).apply(
            tree, jnp.asarray(x), True, rngs={"dropout": jax.random.PRNGKey(4)},
            mutable=["batch_stats"])
    assert [m.shape for m in masks] == [(16, 4096), (16, 256), (16, 64)]
    want, stats = _jax_training_forward(tree, x, masks, monkeypatch, dtype)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    port = load_flax_params(TorchClassifier(), tree).to(tdtype)
    noise = Noise(torch.Generator(), masks, dtype=tdtype)
    got = port(torch.from_numpy(x).to(tdtype), True, noise)
    assert noise.exhausted() and got.dtype == tdtype
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol)
    new_stats = state_dict_to_flax(port.state_dict())["batch_stats"]
    for layer, layer_stats in stats.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(new_stats[layer][k], layer_stats[k], rtol=tol, atol=tol,
                                       err_msg=f"{layer}/{k}")
        assert not np.allclose(layer_stats["var"], tree["batch_stats"][layer]["var"])


def test_variables_tree_converts_both_ways():
    tree = _tree(WEIGHTS[0])
    model = TorchClassifier()
    sd = flax_to_state_dict(tree, model)
    assert {k for k in sd if k.endswith("running_var")} == {f"BatchNorm_{i}.running_var"
                                                            for i in range(3)}
    back = state_dict_to_flax(load_flax_params(model, tree).state_dict())
    assert sorted(back) == ["batch_stats", "params"]
    for part in ("params", "batch_stats"):
        for layer, leaves in tree[part].items():
            assert sorted(back[part][layer]) == sorted(leaves), layer
            for k, v in leaves.items():
                np.testing.assert_array_equal(back[part][layer][k], v)
    missing = {"params": tree["params"], "batch_stats": dict(tree["batch_stats"])}
    del missing["batch_stats"]["BatchNorm_1"]
    with pytest.raises(KeyError, match="BatchNorm_1.running_mean"):
        flax_to_state_dict(missing, model)
    extra = {"params": {**tree["params"], "Dense_9": tree["params"]["Dense_0"]},
             "batch_stats": tree["batch_stats"]}
    with pytest.raises(KeyError, match="Dense_9"):
        flax_to_state_dict(extra, model)


def test_batchnorm_follows_flax_not_batchnorm2d():
    """flax moves the running variance toward the biased batch variance;
    nn.BatchNorm2d toward the unbiased one, n / (n - 1) larger."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 3, 4).astype(np.float32))
    ours = BatchNorm(4)
    y = ours(x, True)
    theirs = torch.nn.BatchNorm2d(4, eps=1e-3, momentum=0.01)
    y2 = theirs(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), y2.detach().numpy(), rtol=1e-4, atol=1e-5)
    biased = x.reshape(-1, 4).var(dim=0, unbiased=False)
    np.testing.assert_allclose(ours.running_var.numpy(), (0.99 + 0.01 * biased).numpy(),
                               rtol=1e-6)
    assert not torch.allclose(ours.running_var, theirs.running_var, rtol=1e-5, atol=0.0)


def test_load_or_train_reads_msgpack_then_pt(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = VaeConfig(synthetic_data=True, synthetic_style="digits", synthetic_size=8192)
    path = probes.classifier_weights_path(cfg)
    os.makedirs("models")
    shutil.copy(os.path.join(REPO, "models", WEIGHTS[0]), path)
    x, _ = _digits(4)
    want = load_weights(path, TorchClassifier())(torch.from_numpy(x), False)
    trained = []
    monkeypatch.setattr(probes, "train_classifier",
                        lambda config, verbose=True, device="cuda": trained.append(1))
    got = probes.load_or_train_classifier(cfg, device="cpu")
    assert torch.equal(got(torch.from_numpy(x), False), want) and not trained
    pt = path[:-len(".msgpack")] + ".pt"
    save_weights(pt, got)
    os.remove(path)
    again = probes.load_or_train_classifier(cfg, device="cpu")
    assert torch.equal(again(torch.from_numpy(x), False), want) and not trained
    os.remove(pt)
    probes.load_or_train_classifier(cfg, device="cpu", verbose=False)
    assert trained == [1]


def test_classifier_main_trains_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    model = classifier_main.main(["--epochs", "1", "-synthetic_data", "--platform", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"classifier epoch 1: train loss (\S+) acc (\S+) test acc (\S+)", out)
    assert m and np.isfinite([float(v) for v in m.groups()]).all(), out
    path = os.path.join("models", "svhn_classifier_weights_synth_blobs_512.pt")
    assert os.path.isfile(path)
    saved = torch.load(path, weights_only=True)
    assert sorted(saved) == sorted(model.state_dict())
    assert not torch.equal(saved["BatchNorm_0.running_mean"], torch.zeros(3))


def test_classifier_main_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        classifier_main.main(["--epochs", "1", "-synthetic_data"])
