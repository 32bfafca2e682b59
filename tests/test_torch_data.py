"""The port's datasets and batch streams (split_vae_torch.data) against the
JAX package's (split_vae_tpu.data): the same bytes for the same seeds.

The synthetic generators, the numpy MultiCUB compositor, the native C++
generator in every background mode it covers (the JAX side loads the library
its own module builds under native/, the port builds the same source into
build/), the MultiCUB cache, the batch index stream over two epochs and the
batches of both of the port's loaders on the CPU, and the SVHN .mat reader
on a file written here.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from scipy.io import savemat  # noqa: E402

from split_vae_torch.core.config import SpairConfig as PortSpair  # noqa: E402
from split_vae_torch.core.config import VaeConfig as PortVae  # noqa: E402
from split_vae_torch.data import celeba as port_celeba  # noqa: E402
from split_vae_torch.data import get_vae_dataset  # noqa: E402
from split_vae_torch.data import loader as port_loader  # noqa: E402
from split_vae_torch.data import multicub as port_multicub  # noqa: E402
from split_vae_torch.data import native as port_native  # noqa: E402
from split_vae_torch.data import svhn as port_svhn  # noqa: E402
from split_vae_tpu.core.config import SpairConfig as JaxSpair  # noqa: E402
from split_vae_tpu.core.config import VaeConfig as JaxVae  # noqa: E402
from split_vae_tpu.data import celeba as jax_celeba  # noqa: E402
from split_vae_tpu.data import loader as jax_loader  # noqa: E402
from split_vae_tpu.data import multicub as jax_multicub  # noqa: E402
from split_vae_tpu.data import native as jax_native  # noqa: E402
from split_vae_tpu.data import svhn as jax_svhn  # noqa: E402


def assert_same_bytes(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_bytes(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["synthetic_svhn", "synthetic_svhn_digits"])
def test_synthetic_svhn_same_bytes(name, seed):
    assert_same_bytes(getattr(port_svhn, name)(24, 8, seed), getattr(jax_svhn, name)(24, 8, seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_celeba_and_sprites_same_bytes(seed):
    assert_same_bytes(port_celeba.synthetic_celeba(64, 6, 4, seed),
                      jax_celeba.synthetic_celeba(64, 6, 4, seed))
    assert_same_bytes(port_multicub.synthetic_sprites(16, seed),
                      jax_multicub.synthetic_sprites(16, seed))
    assert_same_bytes(port_multicub.synthetic_sprites(8, seed, 140.0),
                      jax_multicub.synthetic_sprites(8, seed, 140.0))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bg", ["solid_fixed", "unseen_solid_fixed", "solid_random", "white",
                                "texture", "ckb_rot_6", "unseen_ckb_rot_6", "3x3_ckb"])
def test_numpy_multicub_same_bytes(bg, seed):
    sprites = jax_multicub.synthetic_sprites(16, 5)
    port = port_multicub.MultiCUB(sprites, seed=seed).create_dataset(3, (0, 5), 48, bg, test=True)
    ref = jax_multicub.MultiCUB(sprites, seed=seed).create_dataset(3, (0, 5), 48, bg, test=True)
    assert_same_bytes(port, ref)


def _jax_native_lib():
    """The JAX package's library; another test process may be building it
    under native/ at this moment, so a failed load is retried."""
    for _ in range(20):
        jax_native._lib, jax_native._build_failed = None, False
        if jax_native._ensure_built() is not None:
            return
        time.sleep(1.0)
    pytest.fail("the JAX package's native MultiCUB library did not load")


NATIVE_MODES = {
    "solid_fixed": jax_multicub.TRAIN_COLORS,
    "unseen_solid_fixed": jax_multicub.TEST_COLORS,
    "solid_random": jax_multicub.TRAIN_COLORS,
    "white": [(255, 255, 255)],
    "3x3_ckb": jax_multicub.TRAIN_COLORS,
    "ckb_rot_6": jax_multicub.TRAIN_COLORS_TRIAD,
    "unseen_ckb_rot_6": jax_multicub.TEST_COLORS_TRIAD,
    "texture": jax_multicub.TRAIN_COLORS,
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bg", sorted(NATIVE_MODES))
def test_native_generator_same_bytes(bg, seed):
    _jax_native_lib()
    sprites = jax_multicub.synthetic_sprites(16, 3)
    palette = np.asarray(NATIVE_MODES[bg], np.float32) / 255.0
    port = port_native.generate(sprites, 12, 48, bg, palette, seed=seed)
    ref = jax_native.generate(sprites, 12, 48, bg, palette, seed=seed)
    assert port is not None and ref is not None
    assert_same_bytes(port, ref)
    assert os.path.dirname(port_native.library_path()).endswith("build")


def test_native_unsupported_mode_takes_the_numpy_path():
    sprites = jax_multicub.synthetic_sprites(4, 0)
    assert port_native.generate(sprites, 2, 48, "ckb", np.ones((2, 3), np.float32)) is None
    assert port_native.generate(sprites, 2, 48, "stripes", np.ones((2, 3), np.float32)) is None


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_native, "_SRC", str(bad))
    monkeypatch.setattr(port_native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(port_native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port_native.load()
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


def test_get_multicub_same_bytes_and_shared_cache(tmp_path):
    _jax_native_lib()
    kw = dict(dataset="cub_ckb_rot_6", synthetic_data=True, seed=1)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port = port_multicub.get_multicub(PortSpair(data_dir=str(port_dir), **kw), 40, 12)
    ref = jax_multicub.get_multicub(JaxSpair(data_dir=str(jax_dir), **kw), 40, 12)
    assert port[2] == ref[2] == [-1, 48, 48, 3]
    assert_same_bytes(port[0].images, ref[0].images)
    for p, r in zip(port[1], ref[1]):
        assert_same_bytes((p.images, p.labels), (r.images, r.labels))
    assert os.listdir(port_dir / "multi_cub") == os.listdir(jax_dir / "multi_cub")
    # Either package reads the other's cache.
    other = port_multicub.get_multicub(PortSpair(data_dir=str(jax_dir), **kw), 40, 12)
    assert_same_bytes(other[0].images, ref[0].images)


@pytest.mark.parametrize("shuffle, drop", [(True, True), (False, True), (True, False)])
def test_index_stream_equals_jax(shuffle, drop):
    port = port_loader._epoch_index_batches(23, 5, shuffle, True, 7, drop)
    ref = jax_loader._epoch_index_batches(23, 5, shuffle, True, 7, drop,
                                          process_index=0, process_count=1)
    per_epoch = 4 if drop else 5
    for _ in range(2 * per_epoch):
        assert_same_bytes(next(port), next(ref))


def test_index_stream_refuses_more_processes():
    """The stream refused more than one process until data parallelism came
    (ROADMAP A8); now process 1 of 2 takes the JAX package's slice, index
    for index (more cases in tests/test_torch_parallel.py)."""
    got = list(port_loader._epoch_index_batches(8, 2, True, False, 0, True, 1, 2))
    want = list(jax_loader._epoch_index_batches(8, 2, True, False, 0, True, 1, 2))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_loaders_give_the_jax_batches():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (30, 4, 4, 3)).astype(np.uint8)
    labels = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 30)]
    port_ds = port_loader.ArrayDataset(images, labels)
    jax_ds = jax_loader.ArrayDataset(images, labels)
    ref = list(port_loader.take(jax_loader.iterate_batches(jax_ds, 8, repeat=True, seed=3), 9))
    host = list(port_loader.take(port_loader.iterate_batches(port_ds, 8, repeat=True, seed=3), 9))
    resident = list(port_loader.take(port_loader.device_resident_batches(
        port_ds, 8, repeat=True, seed=3, device="cpu"), 9))
    streamed = list(port_loader.take(port_loader.device_prefetch(
        port_loader.iterate_batches(port_ds, 8, repeat=True, seed=3), device="cpu"), 9))
    for r, h, d, s in zip(ref, host, resident, streamed):
        assert_same_bytes(h, r)
        assert_same_bytes([t.numpy() for t in d], r)
        assert_same_bytes([t.numpy() for t in s], r)
    # Without labels, the test sweep's unshuffled order with its last part batch.
    ref = list(jax_loader.iterate_batches(jax_loader.ArrayDataset(images), 8, shuffle=False,
                                          drop_remainder=False))
    resident = list(port_loader.device_resident_batches(
        port_loader.ArrayDataset(images), 8, shuffle=False, drop_remainder=False, device="cpu"))
    assert [len(b) for b in resident] == [8, 8, 8, 6]
    assert_same_bytes([t.numpy() for t in resident], ref)


def test_svhn_mat_files_read_alike(tmp_path):
    rng = np.random.RandomState(0)
    svhn_dir = tmp_path / "SVHN"
    svhn_dir.mkdir()
    for name, n in (("train", 12), ("test", 6), ("extra", 4)):
        savemat(str(svhn_dir / f"{name}_32x32.mat"),
                {"X": rng.randint(0, 255, (32, 32, 3, n)).astype(np.uint8),
                 "y": rng.randint(1, 11, (n, 1)).astype(np.uint8)})
    assert_same_bytes(port_svhn._load_mat(str(svhn_dir / "train_32x32.mat")),
                      jax_svhn._load_mat(str(svhn_dir / "train_32x32.mat")))
    for dataset in ("svhn", "svhn_no_extra"):
        for no_label in (False, True):
            kw = dict(dataset=dataset, data_dir=str(tmp_path), no_label=no_label)
            port = get_vae_dataset(PortVae(**kw))
            ref = jax_svhn.get_svhn(JaxVae(**kw), extra=dataset == "svhn")
            assert port[2] == ref[2]
            for p, r in zip(port[:2], ref[:2]):
                assert_same_bytes(p.images, r.images)
                assert (p.labels is None) == no_label
                if not no_label:
                    assert_same_bytes(p.labels, r.labels)


def test_missing_files_raise_with_their_path(tmp_path):
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "SVHN" / "train_32x32.mat")):
        get_vae_dataset(PortVae(dataset="svhn", data_dir=str(tmp_path)))
    cache = tmp_path / "celeba"
    with pytest.raises(FileNotFoundError) as err:
        get_vae_dataset(PortVae(dataset="celeba64", data_dir=str(tmp_path), no_label=True))
    assert str(cache / "train_64x64.npy") in str(err.value)
    assert str(cache / "img_align_celeba") in str(err.value)


def test_synthetic_vae_datasets_equal_jax():
    for dataset in ("celeba64", "svhn"):
        kw = dict(dataset=dataset, synthetic_data=True, synthetic_size=16, seed=1,
                  no_label=dataset == "celeba64")
        port = get_vae_dataset(PortVae(**kw))
        from split_vae_tpu.data import get_vae_dataset as jax_get

        ref = jax_get(JaxVae(**kw))
        assert port[2] == ref[2]
        for p, r in zip(port[:2], ref[:2]):
            assert_same_bytes(p.images, r.images)


def test_resident_batches_copy_nothing_within_an_epoch(monkeypatch):
    """After the epoch's order goes up with its first batch, the epoch's other
    batches are gathered where the dataset lies: no tensor is made from host
    memory or moved."""
    images = np.arange(40 * 2 * 2 * 3, dtype=np.float32).reshape(40, 2, 2, 3)
    batches = port_loader.device_resident_batches(port_loader.ArrayDataset(images), 8,
                                                  repeat=True, seed=0, device="cpu")
    first = next(batches)

    def refuse(*args, **kwargs):
        raise AssertionError("a host-device copy within the epoch")

    with monkeypatch.context() as mp:
        mp.setattr(torch, "from_numpy", refuse)
        mp.setattr(torch, "as_tensor", refuse)
        mp.setattr(torch, "tensor", refuse)
        for name in ("to", "cuda", "cpu", "numpy", "item", "pin_memory"):
            mp.setattr(torch.Tensor, name, refuse)
        rest = [next(batches) for _ in range(4)]
    order = np.random.RandomState(0).permutation(40)
    got = np.concatenate([b.numpy() for b in [first] + rest])
    assert np.array_equal(got, images[order])
