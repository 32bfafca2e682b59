"""Checkpoint and resume of the port (split_vae_torch.core.checkpoint) and its
reader of flax's msgpack files (split_vae_torch.interop.flax_msgpack).

A checkpoint round trip is bit-equal in the parameters, Adam's moments and
count, the non-finite count, the step and the generator; only the newest
``keep`` files stay and no ``.tmp`` is left; two steps, a checkpoint, a
restore into a freshly built state and two more steps equal four straight
steps bit for bit; a weights file that the JAX package's ``save_weights``
writes loads into a port model and gives the forward of the parameters
converted by ``flax_params`` (atol 1e-6); the reader gives what flax's own
``msgpack_restore`` gives.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from split_vae_torch.core import checkpoint as ckpt  # noqa: E402
from split_vae_torch.core.config import config2, config5  # noqa: E402
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.core.state import create_train_state  # noqa: E402
from split_vae_torch.interop import flax_msgpack  # noqa: E402
from split_vae_torch.interop.flax_params import load_flax_params  # noqa: E402
from split_vae_torch.models.spair import get_spair_model  # noqa: E402
from split_vae_torch.models.vae import get_vae_model  # noqa: E402
from split_vae_torch.train.optim import spair_optimizer  # noqa: E402
from split_vae_torch.train.steps import make_spair_train_step  # noqa: E402
from split_vae_tpu.core import checkpoint as jax_ckpt  # noqa: E402
from split_vae_tpu.core.config import SpairConfig as JaxSpair  # noqa: E402
from split_vae_tpu.models.spair import get_spair_model as jax_spair_model  # noqa: E402
from split_vae_tpu.models.vae import LGVae as JaxLGVae  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small CPU steps, which
    several test processes side by side would otherwise slow by contending
    for every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

B, HW = 4, 24
SMALL = dict(batch_size=B, latent_size=8, bg_latent_size=8, local_latent_size=8,
             object_size=16)


def _config():
    cfg = config5(**SMALL)
    cfg.image_size = (HW, HW, 3)
    return cfg


def _state(seed=0):
    cfg = _config()
    model = get_spair_model(cfg.replace(seed=seed), device="cpu")
    return cfg, create_train_state(model, spair_optimizer(cfg.learning_rate), seed=seed)


def _batches(n):
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32))
            for _ in range(n)]


def _tensors(state):
    return ([t.clone() for t in state.model.state_dict().values()]
            + [t.clone() for t in ckpt._leaves(state.opt_state)])


def _assert_bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_round_trip_is_bit_equal(tmp_path):
    cfg, state = _state()
    step = make_spair_train_step(cfg)
    for batch in _batches(2):
        state, _ = step(state, batch)
    inner = state.opt_state
    state.opt_state = inner._replace(total_notfinite=torch.tensor(3, dtype=torch.int32))
    path = ckpt.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "checkpoint_2.pt"

    _, fresh = _state(seed=5)
    ckpt.restore_checkpoint(str(tmp_path), fresh)
    _assert_bit_equal(_tensors(fresh), _tensors(state))
    assert fresh.step == 2
    assert int(fresh.opt_state.total_notfinite) == 3
    assert int(fresh.opt_state.inner_state[1].count) == 2
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())


def test_retention_and_atomic_writes(tmp_path):
    _, state = _state()
    for s in (1, 5, 3, 10, 7):
        state.step = s
        ckpt.save_checkpoint(str(tmp_path), state, keep=3)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_10.pt", "checkpoint_5.pt",
                                            "checkpoint_7.pt"]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint_10.pt")
    assert ckpt.latest_checkpoint(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "absent"), state)


def test_restore_refuses_another_optimizer_tree(tmp_path):
    cfg, state = _state()
    path = ckpt.save_checkpoint(str(tmp_path), state)
    from split_vae_torch.train.optim import vae_optimizer

    state.opt_state = vae_optimizer(1e-4).init(state.params)[:1] + (((),),)
    with pytest.raises(ValueError, match="optimizer tensors"):
        ckpt.restore_checkpoint(path, state)


def test_checkpoint_restore_continue_equals_straight_run(tmp_path):
    batches = _batches(4)
    cfg, straight = _state()
    step = make_spair_train_step(cfg)
    straight_metrics = []
    for batch in batches:
        straight, m = step(straight, batch)
        straight_metrics.append(m)

    _, first = _state()
    for batch in batches[:2]:
        first, _ = step(first, batch)
    ckpt.save_checkpoint(str(tmp_path), first)
    _, resumed = _state(seed=9)
    ckpt.restore_checkpoint(str(tmp_path), resumed)
    for batch, ref in zip(batches[2:], straight_metrics[2:]):
        resumed, m = step(resumed, batch)
        for k in ref:
            assert torch.equal(m[k], ref[k]), k
    assert resumed.step == straight.step == 4
    _assert_bit_equal(_tensors(resumed), _tensors(straight))
    assert torch.equal(resumed.generator.get_state(), straight.generator.get_state())


def _jax_tree(module, hw):
    """The JAX model's parameter tree (its names and shapes, from
    ``jax.eval_shape`` of its init) filled with seeded values."""
    shapes = jax.eval_shape(
        lambda k1, k2: module.init({"params": k1, "sample": k2}, jnp.zeros((2, *hw, 6)),
                                   training=True),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))["params"]
    rng = np.random.RandomState(2)
    return jax.tree.map(lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32), shapes)


def _lg_spair():
    return (_jax_tree(jax_spair_model(JaxSpair(**_config().__dict__)), (HW, HW)),
            lambda: get_spair_model(_config(), device="cpu"), (HW, HW))


def _lgvae():
    return (_jax_tree(JaxLGVae(8, 8, (32, 32)), (32, 32)),
            lambda: get_vae_model(config2(global_latent_dims=8, local_latent_dims=8), (32, 32),
                                  device="cpu"), (32, 32))


@pytest.mark.parametrize("build", [_lg_spair, _lgvae], ids=["lg_spair", "lgvae"])
def test_jax_weights_file_loads_into_the_port(tmp_path, build):
    params, make, hw = build()
    path = str(tmp_path / "weights.msgpack")
    jax_ckpt.save_weights(path, params)
    from_file = ckpt.load_weights(path, make())
    converted = load_flax_params(make(), params)
    x = torch.from_numpy(np.random.RandomState(1).uniform(0, 1, (2, *hw, 6)).astype(np.float32))
    with torch.no_grad():
        outs = [m(x, True, Noise(torch.Generator().manual_seed(0)))
                for m in (from_file, converted)]
    for a, b in zip(*outs):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_port_weights_round_trip(tmp_path):
    _, state = _state()
    path = str(tmp_path / "models" / "run.pt")
    ckpt.save_weights(path, state.model)
    _, other = _state(seed=4)
    ckpt.load_weights(path, other.model)
    _assert_bit_equal(list(other.model.state_dict().values()),
                      list(state.model.state_dict().values()))


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


def test_reader_matches_flax_msgpack_restore():
    rng = np.random.RandomState(0)
    tree = {
        "params": {"Conv_0": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
                              "bias": np.zeros((4,), np.float32)},
                   "big": rng.randn(700, 3).astype(np.float32)},
        "ints": {"u8": np.arange(12, dtype=np.uint8), "i64": np.array(2**40, np.int64),
                 "i32": rng.randint(-9, 9, (2, 3)).astype(np.int32), "empty": np.zeros((0, 2))},
        "bools": np.array([True, False, True]),
        "step": np.int32(7), "lr": np.float32(1e-4),
        "name": "run", "long_name": "r" * 300,
        "small": 5, "negative": -3, "int8": -100, "int16": -30000, "uint16": 60000,
        "int32": -2**31, "uint32": 2**32 - 1, "uint64": 2**63, "int64": -2**40,
        "float": 0.1, "nan": float("nan"), "true": True, "false": False, "nil": None,
        "list": [1, "a", 2.5, None, [True]] * 4,
        "map16": {str(i): i for i in range(20)},
    }
    data = flax.serialization.msgpack_serialize(tree)
    _same_tree(flax.serialization.msgpack_restore(data), flax_msgpack.loads(data))


def test_reader_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="ext type"):
        flax_msgpack.loads(bytes([0xD4, 0x07, 0x00]))
    with pytest.raises(ValueError, match="ends"):
        flax_msgpack.loads(bytes([0x92, 0x01]))
    chunked = flax.serialization.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 1}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.loads(chunked)
