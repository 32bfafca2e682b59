"""The port's 2-rank LG-SPAIR step against the JAX package's sharded step.

The JAX side is tests/test_sharding.py's ``_spair_parity_case`` at the port's
small LG-SPAIR shapes (config #5's flags at 24 px, a 2x2 cell grid, B=4,
``interpret_fused=True``): the jitted train step over a 2-device data mesh of
the conftest's virtual CPU devices, the fused render shard-mapped over
'data' (interpret mode: render noise 0). Its draws are recorded from the
unsharded forward on the same keys, outside ``jit``, by wrapping the
samplers where ``spair_nets`` and ``patches`` bind them
(tests/test_torch_spair_step.py); threefry's draws do not depend on the
sharding (tests/test_sharding.py holds the sharded step to the unsharded
one), so they are the sharded step's draws too.

The port side runs in 2 gloo processes (tests/test_torch_parallel.py's
``spawn_ranks``): the converted parameters, render noise 0, each rank its 2
rows of the batch, the draws replayed at the global shape and sliced per
rank. Held: the loss (the ranks' mean) at rtol 1e-4, the parameters after
the update at atol 2e-5 (the JAX test's own), the ranks' parameters
bit-equal.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import split_vae_tpu.nn.spair_nets as jax_nets  # noqa: E402
import split_vae_tpu.ops.patches as jax_patches  # noqa: E402
from split_vae_torch.interop.flax_params import flax_to_state_dict, load_flax_params  # noqa: E402
from split_vae_torch.models.spair import get_spair_model as torch_model  # noqa: E402
from split_vae_tpu.core.config import SpairConfig  # noqa: E402
from split_vae_tpu.core.state import create_train_state as jax_state  # noqa: E402
from split_vae_tpu.models.spair import get_spair_model as jax_model  # noqa: E402
from split_vae_tpu.parallel.mesh import batch_sharding, create_mesh, shard_state  # noqa: E402
from split_vae_tpu.train import optim as jax_optim  # noqa: E402
from split_vae_tpu.train.steps import make_spair_train_step as jax_step  # noqa: E402
from test_torch_parallel import SPAIR_B, SPAIR_HW, WORLD, spair_config, spawn_ranks  # noqa: E402


def _record(monkeypatch):
    """Wraps the JAX samplers so that each draw is also kept, in call order."""
    draws = []

    def reparameterize(key, mean, sigma):
        draws.append(np.array(jax.random.normal(key, sigma.shape, dtype=sigma.dtype)))
        return orig_reparam(key, mean, sigma)

    def concrete(key, log_odds, temperature, eps=1e-8):
        draws.append(np.array(jax.random.uniform(key, log_odds.shape, dtype=log_odds.dtype)))
        return orig_concrete(key, log_odds, temperature, eps)

    def scramble(key, x, size):
        b, h, w, _ = x.shape
        draws.append(np.array(jax.random.uniform(key, (b, (h // size) * (w // size)))))
        return orig_scramble(key, x, size)

    orig_reparam = jax_nets.reparameterize
    orig_concrete = jax_nets.concrete_binary_pre_sigmoid_sample
    orig_scramble = jax_patches.batched_scramble
    monkeypatch.setattr(jax_nets, "reparameterize", reparameterize)
    monkeypatch.setattr(jax_nets, "concrete_binary_pre_sigmoid_sample", concrete)
    monkeypatch.setattr(jax_patches, "batched_scramble", scramble)
    return draws


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
    out = str(tmp_path_factory.mktemp("ranks"))
    torch.save({"params": tmodel.state_dict(), "x": torch.from_numpy(x),
                "replay": [torch.from_numpy(d) for d in draws]}, f"{out}/jax_inputs.pt")

    def sharded_jax_step():
        mesh = create_mesh(num_data=WORLD, devices=jax.devices()[:WORLD])
        with jax.sharding.set_mesh(mesh):
            sharded = shard_state(state, mesh)
            batch = jax.device_put(x, batch_sharding(mesh))
            new_state, metrics = jax_step(jax_cfg)(sharded, batch)
            return (float(metrics["total_loss"]), int(new_state.step),
                    flax_to_state_dict(jax.tree.map(np.asarray, new_state.params), tmodel))

    ranks, jax_side = spawn_ranks(["jax_replay"], out, out, sharded_jax_step)
    return [r["jax_replay"] for r in ranks], jax_side


def test_two_rank_loss_equals_the_jax_sharded_step(both):
    ranks, (loss, step, _) = both
    assert step == 1 and [r["step"] for r in ranks] == [1] * WORLD
    np.testing.assert_allclose(sum(r["loss"] for r in ranks) / WORLD, loss, rtol=1e-4)


def test_two_rank_params_equal_the_jax_sharded_step(both):
    ranks, (_, _, params) = both
    assert sorted(ranks[0]["params"]) == sorted(params)
    for name in params:
        np.testing.assert_allclose(ranks[0]["params"][name].numpy(), params[name].numpy(),
                                   rtol=0, atol=2e-5, err_msg=name)


def test_the_ranks_params_are_bit_equal(both):
    ranks, _ = both
    for name, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][name]), name
