"""The port's tensor-parallel rule and 2 x 2 step against the JAX package's.

- The rule: the port's ``infer_param_sharding`` names the leaves that the JAX
  ``infer_param_sharding`` shards over 'model', mapped by
  ``interop/flax_params.py`` (a flax ``.../kernel`` is the port's
  ``.../weight``): at config #5 and 2 model ranks, on the flax tree's shapes
  from ``jax.eval_shape`` (no JAX initialization), the twelve Dense and Conv
  kernels and no bias; and the three cases of tests/test_sharding.py:120-129
  (a big kernel sharded, a small one and a vector whole).
- The step: tests/test_torch_parallel_jax.py's LG-SPAIR case (config #5's
  flags at 24 px, B=4, ``interpret_fused=True``, render noise 0) with the JAX
  step jitted over a (2 data x 2 model) mesh of the conftest's virtual CPU
  devices after ``shard_state``, and the port in 4 gloo processes of a 2 x 2
  grid (tests/test_torch_tensor_parallel.py's ``spawn_grid``), its weights
  sharded at a ``min_size`` that takes Dense and Conv kernels, the JAX
  package's draws replayed at the global shape. Held: the loss (the ranks'
  mean) at rtol 1e-4; the gathered parameters after the update at Adam's rule
  (atol 1e-5 where the ranks' gathered |g| >= 1e-5) and at atol 2e-5 on
  every element (tests/test_torch_parallel_jax.py's own); the ranks' gathered
  parameters bit-equal.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import split_vae_tpu.ops.patches as jax_patches  # noqa: E402
from split_vae_torch.core.config import config5  # noqa: E402
from split_vae_torch.interop.flax_params import flax_to_state_dict, load_flax_params  # noqa: E402
from split_vae_torch.models.spair import get_spair_model as torch_model  # noqa: E402
from split_vae_torch.nn.common import Dense  # noqa: E402
from split_vae_torch.parallel import mesh as mesh_mod  # noqa: E402
from split_vae_torch.parallel.mesh import Mesh  # noqa: E402
from split_vae_tpu.core.config import SpairConfig  # noqa: E402
from split_vae_tpu.core.state import create_train_state as jax_state  # noqa: E402
from split_vae_tpu.models.spair import get_spair_model as jax_model  # noqa: E402
from split_vae_tpu.parallel.mesh import batch_sharding, create_mesh  # noqa: E402
from split_vae_tpu.parallel.mesh import infer_param_sharding as jax_rule  # noqa: E402
from split_vae_tpu.parallel.mesh import shard_state as jax_shard_state  # noqa: E402
from split_vae_tpu.train import optim as jax_optim  # noqa: E402
from split_vae_tpu.train.steps import make_spair_train_step as jax_step  # noqa: E402
from test_torch_parallel import SPAIR_B, SPAIR_HW, spair_config  # noqa: E402
from test_torch_parallel_jax import _record  # noqa: E402
from test_torch_tensor_parallel import spawn_grid  # noqa: E402

CONFIG5_SHARDED = sorted([
    "bg_encoder.Dense_0.weight", "bg_encoder.Dense_1.weight",
    "x_hat_encoder.Dense_0.weight", "x_hat_encoder.Dense_1.weight",
    "bg_decoder.Dense_1.weight", "bg_decoder.Dense_2.weight",
    "x_hat_decoder.Dense_1.weight", "x_hat_decoder.Dense_2.weight",
    "encoder.obj_encoder.Dense_0.weight", "decoder.ObjDecoder_0.Dense_1.weight",
    "encoder.conv2.weight", "encoder.conv3.weight",
])


def jax_sharded_names(shardings):
    """The port's names of the leaves the JAX rule puts on 'model'."""
    names = []
    for path, sharding in jax.tree_util.tree_leaves_with_path(shardings):
        if "model" in tuple(sharding.spec):
            keys = [k.key for k in path]
            names.append(".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]]))
    return sorted(names)


def test_config5_sharding_is_the_jax_rule():
    cfg = config5()
    model = jax_model(SpairConfig(**cfg.__dict__))
    h, w, _ = cfg.image_size
    shapes = jax.eval_shape(lambda: model.init(
        {k: jax.random.PRNGKey(0) for k in ("params", "sample", "dropout")},
        jnp.zeros((2, h, w, 6)), training=True))["params"]
    mesh = create_mesh(num_data=4, num_model=2)
    want = jax_sharded_names(jax_rule(shapes, mesh))
    port = torch_model(cfg, device="cpu")
    got = mesh_mod.infer_param_sharding(port, Mesh(world=8, model_size=2))
    assert sorted(got) == want == CONFIG5_SHARDED
    sizes = dict(port.named_parameters())
    assert sum(sizes[n].numel() for n in got) == 31_670_272
    assert sum(p.numel() for p in sizes.values()) == 32_073_267


@pytest.mark.parametrize("name, shape, sharded", [
    ("big", (512, 512), True),    # >= min_size, divisible
    ("small", (4, 4), False),     # too small
    ("vec", (512,), False),       # one dimension
])
def test_model_axis_sharding_rule(name, shape, sharded):
    """tests/test_sharding.py:120-129's leaves: the JAX rule on the flax
    leaf, the port's on a Dense of that kernel (its [out, in] weight; a
    vector is a bias)."""
    mesh = create_mesh(num_data=4, num_model=2)
    spec = jax_rule({name: jnp.zeros(shape)}, mesh)[name].spec
    assert ("model" in tuple(spec)) == sharded
    layer = torch.nn.Module()  # flax's [in, out] kernel, or a bias of that length
    layer.dense = Dense(*shape, device="meta") if len(shape) == 2 else Dense(1, shape[0])
    got = mesh_mod.infer_param_sharding(layer, Mesh(world=8, model_size=2))
    assert got == (["dense.weight"] if sharded else [])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    port_cfg = spair_config()
    jax_cfg = SpairConfig(**{**port_cfg.__dict__, "interpret_fused": True})
    x = np.random.RandomState(0).uniform(0, 1, (SPAIR_B, SPAIR_HW, SPAIR_HW, 3)).astype(
        np.float32)
    tx = jax_optim.nan_robust(optax.chain(jax_optim.clip_by_per_tensor_norm(1.0),
                                          jax_optim.adam(jax_cfg.learning_rate)))
    model = jax_model(jax_cfg)
    state = jax_state(model, jnp.zeros((SPAIR_B, SPAIR_HW, SPAIR_HW, 6)), tx, seed=3,
                      training_kwargs={"training": True})
    params0 = jax.tree.map(np.array, state.params)

    # The step's draws: its own keys, the forward outside jit, unsharded.
    _, (k_aug, k_sample) = state.next_rng(2)
    mp = pytest.MonkeyPatch()
    try:
        draws = _record(mp)
        images = jax_patches.augment_batch(k_aug, jnp.asarray(x), "scramble",
                                           jax_cfg.patch_size)
        state.apply_fn({"params": state.params}, images, True, rngs={"sample": k_sample})
    finally:
        mp.undo()

    tmodel = torch_model(port_cfg, device="cpu")
    load_flax_params(tmodel, params0)
    out = str(tmp_path_factory.mktemp("grid"))
    torch.save({"params": tmodel.state_dict(), "x": torch.from_numpy(x),
                "replay": [torch.from_numpy(d) for d in draws]}, f"{out}/jax_inputs.pt")

    wait = spawn_grid((2, 2), ["jax_replay"], out, out)
    mesh = create_mesh(num_data=2, num_model=2, devices=jax.devices()[:4])
    with jax.sharding.set_mesh(mesh):
        sharded = jax_shard_state(state, mesh)
        placed = jax_sharded_names(jax.tree.map(lambda a: a.sharding, sharded.params))
        batch = jax.device_put(x, batch_sharding(mesh))
        new_state, metrics = jax_step(jax_cfg)(sharded, batch)
        jax_side = (float(metrics["total_loss"]), int(new_state.step), placed,
                    flax_to_state_dict(jax.tree.map(np.asarray, new_state.params), tmodel))
    return [r["jax_replay"] for r in wait()], jax_side


def test_grid_loss_equals_the_jax_sharded_step(both):
    ranks, (loss, step, placed, _) = both
    assert placed and step == 1 and [r["step"] for r in ranks] == [1] * 4
    assert set(placed) <= set(ranks[0]["names"])  # the port shards what JAX does, and more
    np.testing.assert_allclose(np.mean([r["loss"] for r in ranks]), loss, rtol=1e-4)


def test_grid_params_equal_the_jax_sharded_step(both):
    ranks, (_, _, _, params) = both
    got, grads = ranks[0]["params"], ranks[0]["grads"]
    assert sorted(got) == sorted(params)
    for name in params:
        want = params[name].numpy()
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0, atol=2e-5, err_msg=name)
        if name in grads:
            held = grads[name].abs().numpy() >= 1e-5
            np.testing.assert_allclose(got[name].numpy()[held], want[held], rtol=0, atol=1e-5,
                                       err_msg=name)


def test_the_grid_ranks_params_are_bit_equal(both):
    ranks, _ = both
    for other in ranks[1:]:
        for name, p in ranks[0]["params"].items():
            assert torch.equal(p, other["params"][name]), name

