"""The whole SPAIR family of the port against the JAX package, one train step each.

Five configurations at a small shape (24-px canvases, a 2x2 cell grid,
latents 8, B=4): SPAIR, BG-SPAIR, LGGlimpseSPAIR (12-px objects in 4-px
patches, so the JAX render takes its unpacked regime), LG-SPAIR with the conv
background and local paths, and LG-SPAIR with ``split_z_l=False``,
``concat_z_bg``, ``concat_backbone`` and ``concat_z_what``.

The JAX side runs as tests/test_torch_spair_step.py runs it
(``interpret_fused=True``: the fused Pallas render in interpret mode, noise
0). The port gets the converted parameters, render noise 0, and the JAX
side's draws replayed in order: the scramble's uniforms, the
reparameterization normals, the Concrete uniforms and, for LGGlimpseSPAIR,
the one shared patch permutation, in the port's form of it
(``Noise.batch_permutation``: [B, n] uniforms whose row 0 sorts in the
JAX permutation's order).

Held: every SpairOutput field (atol 1e-4, rtol 1e-4), every metric (rtol
1e-4), the clipped gradients tensor by tensor (rtol 1e-3, atol 1e-6 max|g|)
and, for BG-SPAIR, the jitted step's metrics and the parameters after the
Adam update (atol 1e-5; the lr is 1e-4, so a looser bound would accept any
update).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import split_vae_tpu.models.spair as jax_spair  # noqa: E402
import split_vae_tpu.nn.spair_nets as jax_nets  # noqa: E402
import split_vae_tpu.ops.patches as jax_patches  # noqa: E402
from split_vae_torch.core import tracing  # noqa: E402
from split_vae_torch.core.config import SpairConfig as PortConfig  # noqa: E402
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
from split_vae_tpu.train import losses as jax_losses  # noqa: E402
from split_vae_tpu.train import optim as jax_optim  # noqa: E402
from split_vae_tpu.train.steps import make_spair_train_step as jax_step  # noqa: E402

B, HW = 4, 24
SMALL = dict(batch_size=B, latent_size=8, bg_latent_size=8, local_latent_size=8,
             image_size=(HW, HW, 3))
VARIANTS = {
    "spair": dict(model="spair", object_size=16),
    "bg_spair": dict(model="bg_spair", object_size=16),
    "lg_glimpse_spair": dict(model="lg_glimpse_spair", object_size=12, patch_size=4),
    "lg_spair_conv": dict(model="lg_spair", object_size=16, patch_size=8, split_z_l=True,
                          concat_z_what=True),
    "lg_spair_concat": dict(model="lg_spair", object_size=12, patch_size=8, split_z_l=False,
                            concat_z_bg=True, concat_backbone=True, concat_z_what=True,
                            dense_local=True),
}
STEP_VARIANT = "bg_spair"  # the one whose jitted step and Adam update are held too


def small_configs(variant: str):
    """(JAX config, port config) of a variant; the JAX side interprets its fused render."""
    port_cfg = PortConfig(**{**SMALL, **VARIANTS[variant]})
    jax_cfg = SpairConfig(**{**port_cfg.__dict__, "interpret_fused": True})
    return jax_cfg, port_cfg


def as_batch_permutation(perm: np.ndarray, rows: int) -> np.ndarray:
    """The draw of ``Noise.batch_permutation`` that gives ``perm``: [rows, n]
    float64 uniforms whose row 0 sorts in perm's order."""
    rank = np.argsort(perm)
    return np.tile((rank + 0.5) / len(perm), (rows, 1))


def record_draws(mp):
    """Wraps every sampler of the JAX package's SPAIR forward so that each draw
    is also kept, in call order: the scramble's uniforms, the normals of
    ``reparameterize``, the Concrete uniforms, the glimpse scramble's shared
    permutation (as the port draws it) and the unfused render's noise."""
    draws = []
    orig_reparam = jax_nets.reparameterize
    orig_concrete = jax_nets.concrete_binary_pre_sigmoid_sample
    orig_scramble = jax_patches.batched_scramble
    orig_permutation = jax.random.permutation
    orig_render = jax_spair.render

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

    def permutation(key, n, *args, **kwargs):
        perm = orig_permutation(key, n, *args, **kwargs)
        draws.append(as_batch_permutation(np.array(perm), B))
        return perm

    def render(full, bg, z_depth, z_pres, z_pres_logits, key, training, num_channel):
        if training:  # the same key, shape and dtype as render's own draw
            shape = full.shape[:-1] + (num_channel,)
            draws.append(np.array(jax.random.normal(key, shape, dtype=jnp.float32)))
        return orig_render(full, bg, z_depth, z_pres, z_pres_logits, key, training, num_channel)

    mp.setattr(jax_nets, "reparameterize", reparameterize)
    mp.setattr(jax_nets, "concrete_binary_pre_sigmoid_sample", concrete)
    mp.setattr(jax_patches, "batched_scramble", scramble)
    mp.setattr(jax.random, "permutation", permutation)
    mp.setattr(jax_spair, "render", render)
    return draws


@pytest.fixture(scope="module", params=list(VARIANTS))
def both(request):
    """Forward, loss and clipped gradients of one variant on both sides."""
    variant = request.param
    mp = pytest.MonkeyPatch()
    try:
        jax_cfg, port_cfg = small_configs(variant)
        lg = jax_cfg.model == "lg_spair"
        x = np.random.RandomState(11).uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)

        tx = jax_optim.nan_robust(optax.chain(jax_optim.clip_by_per_tensor_norm(1.0),
                                              jax_optim.adam(jax_cfg.learning_rate)))
        model = jax_spair.get_spair_model(jax_cfg)
        state = jax_state(model, jnp.zeros((B, HW, HW, 6 if lg else 3)), tx, seed=3,
                          training_kwargs={"training": True})
        params0 = jax.tree.map(np.array, state.params)
        _, (k_aug, k_sample) = state.next_rng(2)
        draws = record_draws(mp)
        images = jnp.asarray(x)
        if lg:
            images = jax_patches.augment_batch(k_aug, images, "scramble", jax_cfg.patch_size)

        def loss(p):
            out = state.apply_fn({"params": p}, images, True, rngs={"sample": k_sample})
            total, metrics = jax_losses.spair_loss(out, images, jax_cfg, jnp.float32(0.0),
                                                   training=True)
            return total, (out, metrics)

        (_, (j_out, j_metrics)), j_grads = jax.value_and_grad(loss, has_aux=True)(state.params)
        j_clipped, _ = jax_optim.clip_by_per_tensor_norm(1.0).update(j_grads, None)
        replay = list(draws)
        mp.undo()  # a jitted step draws the same numbers from the same keys

        tmodel = torch_model(port_cfg, device="cpu")
        load_flax_params(tmodel, params0)
        tmodel.render_noise_scale = 0.0
        t_images, model_draws = torch.from_numpy(x), replay
        if lg:
            t_images = torch_augment(t_images, "scramble", port_cfg.patch_size,
                                     u=torch.from_numpy(replay[0]))
            model_draws = replay[1:]
        noise = Noise(torch.Generator().manual_seed(0), model_draws)
        t_out = tmodel(t_images, True, noise)
        assert noise.exhausted()
        total, t_metrics = torch_losses.spair_loss(t_out, t_images, port_cfg, 0, training=True)
        names = [n for n, _ in tmodel.named_parameters()]
        t_grads = torch.autograd.grad(total, [p for _, p in tmodel.named_parameters()])
        t_clipped, _ = torch_clip(1.0).update(list(t_grads), ())
        result = dict(
            variant=variant,
            out=(j_out, t_out),
            metrics=(j_metrics, t_metrics),
            grads=(flax_to_state_dict(jax.tree.map(np.asarray, j_clipped), tmodel),
                   dict(zip(names, t_clipped))),
        )
        if variant == STEP_VARIANT:
            new_state, j_step_metrics = jax_step(jax_cfg)(state, jnp.asarray(x))
            tstate = torch_state(tmodel, spair_optimizer(port_cfg.learning_rate), seed=0)
            launches = tracing.counters()
            tstate, t_step_metrics = torch_step(port_cfg)(tstate, torch.from_numpy(x), replay)
            # No kernel launched; one update through the foreach chain, in the
            # graphed step's eager path (the CPU's).
            assert tracing.counters() == {**launches,
                                          "optim.foreach": launches.get("optim.foreach", 0) + 1,
                                          "step.eager": launches.get("step.eager", 0) + 1}
            result.update(
                step_metrics=(j_step_metrics, t_step_metrics),
                params=(flax_to_state_dict(jax.tree.map(np.asarray, new_state.params), tmodel),
                        tmodel.state_dict()),
                step=(int(new_state.step), tstate.step))
        return result
    finally:
        mp.undo()


@pytest.mark.parametrize("field", list(jax_spair.SpairOutput._fields))
def test_forward_outputs_match(both, field):
    j_out, t_out = both["out"]
    want, got = getattr(j_out, field), getattr(t_out, field)
    assert (want is None) == (got is None), field
    if want is not None:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=field)


def _assert_metrics(want, got):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4, err_msg=k)


def test_metrics_match(both):
    _assert_metrics(*both["metrics"])


def test_clipped_gradients_match(both):
    want, got = both["grads"]
    assert sorted(got) == sorted(want)
    for name in want:
        w = want[name].numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-3,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_step_metrics_and_params_after_adam_match(both):
    if both["variant"] != STEP_VARIANT:
        # Held for one model: the update chain is the same code for all of them.
        assert "params" not in both
        return
    _assert_metrics(*both["step_metrics"])
    assert both["step"] == (1, 1)
    want, got = both["params"]
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
