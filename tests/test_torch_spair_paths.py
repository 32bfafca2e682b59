"""LG-SPAIR's other forward paths, the port against the JAX package.

tests/test_torch_spair_step.py holds the training step through the fused
render. This file holds the two paths that do not take it, at the same small
shape (24-px canvases, 16-px objects, a 2x2 cell grid) with converted
parameters and the JAX side's draws replayed in order:

- training with ``fused=False``: decoder, then the unfused ``render`` with
  its N(0, 0.01) noise (recorded by wrapping ``render`` where
  ``models/spair.py`` binds it), then the loss and its gradients;
- the eval forward (``training=False``: z_pres = round(sigmoid(logits)), no
  render noise) and the eval loss, with its pinned anneals and the
  concat([z_bg, z_l]) KL quirk.

Held as the step test holds them: outputs atol/rtol 1e-4, metrics rtol 1e-4,
gradients rtol 1e-3 with atol 1e-6 max|g|.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import split_vae_tpu.models.spair as jax_spair  # noqa: E402
import split_vae_tpu.nn.spair_nets as jax_nets  # noqa: E402
from split_vae_torch.core.config import config5  # noqa: E402
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.interop.flax_params import flax_to_state_dict, load_flax_params  # noqa: E402
from split_vae_torch.models.spair import get_spair_model as torch_model  # noqa: E402
from split_vae_torch.train import losses as torch_losses  # noqa: E402
from split_vae_tpu.core.config import SpairConfig  # noqa: E402
from split_vae_tpu.train import losses as jax_losses  # noqa: E402

B, HW = 4, 24
SMALL = dict(batch_size=B, latent_size=8, bg_latent_size=8, local_latent_size=8,
             object_size=16)


def _record(mp):
    """Wraps the JAX samplers and the unfused render; each draw is kept in order."""
    draws = []
    orig_reparam = jax_nets.reparameterize
    orig_concrete = jax_nets.concrete_binary_pre_sigmoid_sample
    orig_render = jax_spair.render

    def reparameterize(key, mean, sigma):
        draws.append(np.array(jax.random.normal(key, sigma.shape, dtype=sigma.dtype)))
        return orig_reparam(key, mean, sigma)

    def concrete(key, log_odds, temperature, eps=1e-8):
        draws.append(np.array(jax.random.uniform(key, log_odds.shape, dtype=log_odds.dtype)))
        return orig_concrete(key, log_odds, temperature, eps)

    def render(full, bg, z_depth, z_pres, z_pres_logits, key, training, num_channel):
        if training:  # the same key, shape and dtype as render's own draw
            shape = full.shape[:-1] + (num_channel,)
            draws.append(np.array(jax.random.normal(key, shape, dtype=jnp.float32)))
        return orig_render(full, bg, z_depth, z_pres, z_pres_logits, key, training, num_channel)

    mp.setattr(jax_nets, "reparameterize", reparameterize)
    mp.setattr(jax_nets, "concrete_binary_pre_sigmoid_sample", concrete)
    mp.setattr(jax_spair, "render", render)
    return draws


@pytest.fixture(scope="module")
def both_paths():
    mp = pytest.MonkeyPatch()
    try:
        port_cfg = config5(**SMALL)
        port_cfg.image_size = (HW, HW, 3)
        jax_cfg = SpairConfig(**port_cfg.__dict__)
        rng = np.random.RandomState(5)
        images = rng.uniform(0, 1, (B, HW, HW, 6)).astype(np.float32)

        model = jax_spair.get_spair_model(jax_cfg)
        params = model.init({"params": jax.random.PRNGKey(4), "sample": jax.random.PRNGKey(5)},
                            jnp.zeros((B, HW, HW, 6)), training=True)["params"]
        params_np = jax.tree.map(np.array, params)
        tmodel = torch_model(port_cfg, device="cpu")
        load_flax_params(tmodel, params_np)
        t_images = torch.from_numpy(images)
        result = {}

        # Training, unfused render.
        draws = _record(mp)

        def loss(p):
            out = model.apply({"params": p}, jnp.asarray(images), True, fused=False,
                              rngs={"sample": jax.random.PRNGKey(6)})
            total, metrics = jax_losses.spair_loss(out, jnp.asarray(images), jax_cfg,
                                                   jnp.float32(3.0), training=True)
            return total, (out, metrics)

        (_, (j_out, j_metrics)), j_grads = jax.value_and_grad(loss, has_aux=True)(params)
        noise = Noise(torch.Generator().manual_seed(0), draws)
        t_out = tmodel(t_images, True, noise, fused=False)
        assert noise.exhausted()
        total, t_metrics = torch_losses.spair_loss(t_out, t_images, port_cfg, 3,
                                                   training=True)
        names = [n for n, _ in tmodel.named_parameters()]
        t_grads = torch.autograd.grad(total, [p for _, p in tmodel.named_parameters()])
        result["train"] = dict(
            out=(j_out, t_out), metrics=(j_metrics, t_metrics),
            grads=(flax_to_state_dict(jax.tree.map(np.asarray, j_grads), tmodel),
                   dict(zip(names, t_grads))))

        # Eval forward and eval loss.
        draws.clear()
        j_out = model.apply({"params": params}, jnp.asarray(images), False,
                            rngs={"sample": jax.random.PRNGKey(7)})
        _, j_metrics = jax_losses.spair_loss(j_out, jnp.asarray(images), jax_cfg,
                                             jnp.float32(3.0), training=False)
        noise = Noise(torch.Generator().manual_seed(0), list(draws))
        with torch.no_grad():
            t_out = tmodel(t_images, False, noise)
            _, t_metrics = torch_losses.spair_loss(t_out, t_images, port_cfg, 3,
                                                   training=False)
        assert noise.exhausted()
        result["eval"] = dict(out=(j_out, t_out), metrics=(j_metrics, t_metrics))
        return result
    finally:
        mp.undo()


@pytest.mark.parametrize("path", ["train", "eval"])
@pytest.mark.parametrize("field", list(jax_spair.SpairOutput._fields))
def test_outputs_match(both_paths, path, field):
    j_out, t_out = both_paths[path]["out"]
    want, got = getattr(j_out, field), getattr(t_out, field)
    assert (want is None) == (got is None), field
    if want is not None:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=field)


@pytest.mark.parametrize("path", ["train", "eval"])
def test_metrics_match(both_paths, path):
    want, got = both_paths[path]["metrics"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4,
                                   err_msg=k)


def test_unfused_gradients_match(both_paths):
    want, got = both_paths["train"]["grads"]
    assert sorted(got) == sorted(want)
    for name in want:
        w = want[name].numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-3,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)
