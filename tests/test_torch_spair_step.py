"""One whole LG-SPAIR train step of the port against the JAX package.

The JAX side is built as tests/test_sharding.py builds it (config #5's flags
at 24 px with a 2x2 cell grid, ``interpret_fused=True``): its fused render
runs the packed Pallas kernel in interpret mode, with noise 0. The port gets
the converted parameters, the render noise set to 0 as well, and the JAX
side's draws replayed in order: the scramble's uniforms (patches.py:75), then
the reparameterization normals and the Concrete uniforms, recorded by
wrapping the samplers where ``spair_nets`` binds them.

Held: every SpairOutput field (atol 1e-4, rtol 1e-4), every metric (rtol
1e-4), the clipped gradients tensor by tensor (rtol 1e-3, atol 1e-6 max|g|)
and the parameters after the Adam update (atol 1e-5; the lr is 1e-4, so a
looser bound would accept any update).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import split_vae_tpu.nn.spair_nets as jax_nets  # noqa: E402
import split_vae_tpu.ops.patches as jax_patches  # noqa: E402
from split_vae_torch.core import tracing  # noqa: E402
from split_vae_torch.core.config import config5  # noqa: E402
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.core.state import create_train_state as torch_state  # noqa: E402
from split_vae_torch.interop.flax_params import flax_to_state_dict, load_flax_params  # noqa: E402
from split_vae_torch.models.spair import get_spair_model as torch_model  # noqa: E402
from split_vae_torch.ops.patches import augment_batch as torch_augment  # noqa: E402
from split_vae_torch.train import losses as torch_losses  # noqa: E402
from split_vae_torch.train.optim import clip_by_per_tensor_norm as torch_clip  # noqa: E402
from split_vae_torch.train.optim import spair_optimizer  # noqa: E402
from split_vae_torch.train.steps import make_spair_train_step as torch_step  # noqa: E402
from split_vae_tpu.core.config import SpairConfig  # noqa: E402
from split_vae_tpu.core.state import create_train_state as jax_state  # noqa: E402
from split_vae_tpu.models.spair import get_spair_model as jax_model  # noqa: E402
from split_vae_tpu.train import losses as jax_losses  # noqa: E402
from split_vae_tpu.train import optim as jax_optim  # noqa: E402
from split_vae_tpu.train.steps import make_spair_train_step as jax_step  # noqa: E402

B, HW = 4, 24
SMALL = dict(batch_size=B, latent_size=8, bg_latent_size=8, local_latent_size=8,
             object_size=16)


def _configs():
    port_cfg = config5(**SMALL)
    port_cfg.image_size = (HW, HW, 3)
    jax_cfg = SpairConfig(**{**port_cfg.__dict__, "interpret_fused": True})
    return jax_cfg, port_cfg


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
def both_steps():
    """Runs the JAX side once (forward, gradients, step) and the port the same way."""
    mp = pytest.MonkeyPatch()
    try:
        jax_cfg, port_cfg = _configs()
        x = np.random.RandomState(0).uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)

        # --- JAX: the step's own keys, then forward + loss + gradients outside jit.
        tx = jax_optim.nan_robust(optax.chain(jax_optim.clip_by_per_tensor_norm(1.0),
                                              jax_optim.adam(jax_cfg.learning_rate)))
        model = jax_model(jax_cfg)
        state = jax_state(model, jnp.zeros((B, HW, HW, 6)), tx, seed=3,
                          training_kwargs={"training": True})
        params0 = jax.tree.map(np.array, state.params)
        _, (k_aug, k_sample) = state.next_rng(2)
        draws = _record(mp)
        images = jax_patches.augment_batch(k_aug, jnp.asarray(x), "scramble",
                                           jax_cfg.patch_size)

        def loss(p):
            out = state.apply_fn({"params": p}, images, True, rngs={"sample": k_sample})
            total, metrics = jax_losses.spair_loss(out, images, jax_cfg, jnp.float32(0.0),
                                                   training=True)
            return total, (out, metrics)

        (_, (j_out, j_metrics)), j_grads = jax.value_and_grad(loss, has_aux=True)(
            state.params)
        j_clipped, _ = jax_optim.clip_by_per_tensor_norm(1.0).update(j_grads, None)
        replay = list(draws)
        mp.undo()  # the jitted step draws the same numbers from the same keys
        new_state, j_step_metrics = jax_step(jax_cfg)(state, jnp.asarray(x))

        # --- Port: converted params, render noise 0, the same draws.
        tmodel = torch_model(port_cfg, device="cpu")
        load_flax_params(tmodel, params0)
        tmodel.render_noise_scale = 0.0
        t_images = torch_augment(torch.from_numpy(x), "scramble", port_cfg.patch_size,
                                 u=torch.from_numpy(replay[0]))
        noise = Noise(torch.Generator().manual_seed(0), replay[1:])
        t_out = tmodel(t_images, True, noise)
        assert noise.exhausted()
        total, t_metrics = torch_losses.spair_loss(t_out, t_images, port_cfg, 0,
                                                   training=True)
        names = [n for n, _ in tmodel.named_parameters()]
        t_grads = torch.autograd.grad(total, [p for _, p in tmodel.named_parameters()])
        t_clipped, _ = torch_clip(1.0).update(list(t_grads), ())

        tstate = torch_state(tmodel, spair_optimizer(port_cfg.learning_rate), seed=0)
        launches = tracing.counters()
        tstate, t_step_metrics = torch_step(port_cfg)(tstate, torch.from_numpy(x), replay)
        assert tracing.counters() == launches
        return dict(
            images=(np.asarray(images), t_images.numpy()),
            out=(j_out, t_out),
            metrics=(j_metrics, t_metrics),
            step_metrics=(j_step_metrics, t_step_metrics),
            grads=(flax_to_state_dict(jax.tree.map(np.asarray, j_clipped), tmodel),
                   dict(zip(names, t_clipped))),
            params=(flax_to_state_dict(jax.tree.map(np.asarray, new_state.params), tmodel),
                    tmodel.state_dict()),
            step=(int(new_state.step), tstate.step),
        )
    finally:
        mp.undo()


def test_scrambled_inputs_match(both_steps):
    want, got = both_steps["images"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("field", [f for f in jax_model.__globals__["SpairOutput"]._fields])
def test_forward_outputs_match(both_steps, field):
    j_out, t_out = both_steps["out"]
    want, got = getattr(j_out, field), getattr(t_out, field)
    assert (want is None) == (got is None), field
    if want is not None:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=field)


@pytest.mark.parametrize("which", ["metrics", "step_metrics"])
def test_metrics_match(both_steps, which):
    want, got = both_steps[which]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4, err_msg=k)


def test_clipped_gradients_match(both_steps):
    want, got = both_steps["grads"]
    assert sorted(got) == sorted(want)
    for name in want:
        w = want[name].numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-3,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_params_after_adam_match(both_steps):
    want, got = both_steps["params"]
    assert both_steps["step"] == (1, 1)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
