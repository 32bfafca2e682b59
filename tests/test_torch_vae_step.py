"""One whole LGVae train step and one eval step of the port against the JAX package.

Two shapes: SVHN (32x32, patch 4) and CelebA64 (64x64, patch 8, BASELINE
config #2's flags with narrow latents), uint8 batches of 4. The JAX side
builds model and optimizer as ``train/loop.py::build_vae_model`` does. The
port gets the converted parameters and the JAX side's draws replayed in
order: the scramble's uniforms (patches.py:75), then the two encoders'
normals, recorded by wrapping the samplers where the JAX modules bind them.

Held: the scrambled inputs (1e-6), every metric of the step (rtol 1e-4), the
gradients tensor by tensor (rtol 1e-3, atol 1e-6 max|g|), the parameters
after the Adam update (atol 1e-5; the lr is 1e-4, so a looser bound would
accept any update), and the eval step's outputs (1e-4) and metrics.

Adam's first update is -lr g / (|g| + 1e-7). This chain has no clipping, and
a few gradient entries of a step lie near 1e-7, where the rounding of g
itself (another summation order in the two packages' convolutions) moves the
update by up to 2 lr. So the parameters are held at atol 1e-5 wherever
|g| >= 1e-5, and elsewhere the gradient test holds g; at most one entry in
ten thousand may differ there.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import split_vae_tpu.nn.encoders as jax_encoders  # noqa: E402
import split_vae_tpu.ops.patches as jax_patches  # noqa: E402
from split_vae_torch.core.config import VaeConfig as PortConfig  # noqa: E402
from split_vae_torch.core.config import config2  # noqa: E402
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.core.state import create_train_state as torch_state  # noqa: E402
from split_vae_torch.interop.flax_params import flax_to_state_dict, load_flax_params  # noqa: E402
from split_vae_torch.models.vae import get_vae_model as torch_model  # noqa: E402
from split_vae_torch.train import losses as torch_losses  # noqa: E402
from split_vae_torch.train.optim import vae_optimizer  # noqa: E402
from split_vae_torch.train.steps import augment as torch_augment  # noqa: E402
from split_vae_torch.train.steps import make_vae_eval_step as torch_eval  # noqa: E402
from split_vae_torch.train.steps import make_vae_train_step as torch_step  # noqa: E402
from split_vae_torch.train.steps import normalize_images as torch_normalize  # noqa: E402
from split_vae_tpu.core.config import VaeConfig  # noqa: E402
from split_vae_tpu.core.state import create_train_state as jax_state  # noqa: E402
from split_vae_tpu.models.vae import LGVaeOutput  # noqa: E402
from split_vae_tpu.train import losses as jax_losses  # noqa: E402
from split_vae_tpu.train.loop import build_vae_model  # noqa: E402
from split_vae_tpu.train.steps import make_vae_eval_step as jax_eval  # noqa: E402
from split_vae_tpu.train.steps import make_vae_train_step as jax_step  # noqa: E402
from split_vae_tpu.train.steps import normalize_images  # noqa: E402

B = 4
CASES = {
    "svhn32": ((32, 32), PortConfig(batch_size=B, patch_size=4, global_latent_dims=16,
                                    local_latent_dims=16)),
    "celeba64": ((64, 64), config2(batch_size=B, global_latent_dims=8, local_latent_dims=8)),
}


def _record(mp):
    """Wraps the JAX samplers so that each draw is also kept, in call order."""
    draws = []
    orig_reparam = jax_encoders.reparameterize
    orig_scramble = jax_patches.batched_scramble

    def reparameterize(key, mean, sigma):
        draws.append(np.array(jax.random.normal(key, sigma.shape, dtype=sigma.dtype)))
        return orig_reparam(key, mean, sigma)

    def scramble(key, x, size):
        b, h, w, _ = x.shape
        draws.append(np.array(jax.random.uniform(key, (b, (h // size) * (w // size)))))
        return orig_scramble(key, x, size)

    mp.setattr(jax_encoders, "reparameterize", reparameterize)
    mp.setattr(jax_patches, "batched_scramble", scramble)
    return draws


@pytest.fixture(scope="module", params=sorted(CASES))
def both_steps(request):
    """Runs the JAX side once (forward, gradients, jitted step, eval step) and
    the port the same way."""
    hw, port_cfg = CASES[request.param]
    jax_cfg = VaeConfig(**port_cfg.__dict__)
    mp = pytest.MonkeyPatch()
    try:
        batch = np.random.RandomState(0).randint(0, 255, (B, *hw, 3)).astype(np.uint8)
        model, tx = build_vae_model(jax_cfg, hw)
        state = jax_state(model, jnp.zeros((B, *hw, 6)), tx, seed=3)
        params0 = jax.tree.map(np.array, state.params)
        _, (k_aug, k_sample, k_drop) = state.next_rng(3)

        # --- JAX: the step's own keys, then forward + loss + gradients outside jit.
        draws = _record(mp)
        x = normalize_images(jnp.asarray(batch), "tanh")
        images = jax_patches.augment_batch(k_aug, x, jax_cfg.augmentation, jax_cfg.patch_size)

        def loss(p):
            out = state.apply_fn({"params": p}, images, True,
                                 rngs={"sample": k_sample, "dropout": k_drop})
            return jax_losses.lgvae_loss(out, images, jax_cfg.beta)

        (_, j_metrics), j_grads = jax.value_and_grad(loss, has_aux=True)(state.params)
        replay = list(draws)
        del draws[:]
        # The eval step splits its key in two: the scramble, then the samples.
        eval_rng = jax.random.PRNGKey(11)
        e_aug, e_sample = jax.random.split(eval_rng)
        e_images = jax_patches.augment_batch(e_aug, x, jax_cfg.augmentation, jax_cfg.patch_size)
        state.apply_fn({"params": state.params}, e_images, False, rngs={"sample": e_sample})
        eval_replay = list(draws)
        mp.undo()  # the jitted steps draw the same numbers from the same keys
        j_eval_out, j_eval_metrics, j_eval_images = jax_eval(jax_cfg, state.apply_fn)(
            state.params, eval_rng, jnp.asarray(batch))
        new_state, j_step_metrics = jax_step(jax_cfg)(state, jnp.asarray(batch))

        # --- Port: converted params, the same draws.
        tmodel = load_flax_params(torch_model(port_cfg, hw, device="cpu"), params0)
        tbatch = torch.from_numpy(batch)
        t_eval_out, t_eval_metrics, t_eval_images = torch_eval(port_cfg, tmodel)(
            torch.Generator(), tbatch, eval_replay)
        names = [n for n, _ in tmodel.named_parameters()]
        before = [p.detach().clone() for p in tmodel.parameters()]
        tstate = torch_state(tmodel, vae_optimizer(port_cfg.learning_rate), seed=0)
        tstate, t_step_metrics = torch_step(port_cfg)(tstate, tbatch, replay)
        # The gradients, from a second copy at the unchanged parameters.
        fresh = load_flax_params(torch_model(port_cfg, hw, device="cpu"), params0)
        f_images = torch_augment(port_cfg, torch_normalize(tbatch, "tanh"),
                                 Noise(torch.Generator(), replay[:1]))
        f_out = fresh(f_images, True, Noise(torch.Generator(), replay[1:]))
        f_total, _ = torch_losses.lgvae_loss(f_out, f_images, port_cfg.beta)
        t_grads = torch.autograd.grad(f_total, list(fresh.parameters()))
        return dict(
            images=(np.asarray(images), f_images.numpy()),
            metrics=(j_metrics, t_step_metrics),
            step_metrics=(j_step_metrics, t_step_metrics),
            grads=(flax_to_state_dict(jax.tree.map(np.asarray, j_grads), tmodel),
                   dict(zip(names, t_grads))),
            params=(flax_to_state_dict(jax.tree.map(np.asarray, new_state.params), tmodel),
                    tmodel.state_dict()),
            moved=sum(int((a != b).any()) for a, b in zip(before, tmodel.parameters())),
            step=(int(new_state.step), tstate.step),
            eval_out=(j_eval_out, t_eval_out),
            eval_metrics=(j_eval_metrics, t_eval_metrics),
            eval_images=(np.asarray(j_eval_images), t_eval_images.numpy()),
        )
    finally:
        mp.undo()


def test_scrambled_inputs_match(both_steps):
    for key in ("images", "eval_images"):
        want, got = both_steps[key]
        assert got.shape[-1] == 6 and np.abs(got).max() <= 1.0
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", ["metrics", "step_metrics", "eval_metrics"])
def test_metrics_match(both_steps, which):
    want, got = both_steps[which]
    want = {k: v for k, v in want.items()}
    if which == "metrics":  # the unjitted JAX loss has no optimizer column
        got = {k: v for k, v in got.items() if k != "notfinite_updates"}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_gradients_match(both_steps):
    want, got = both_steps["grads"]
    assert sorted(got) == sorted(want)
    for name in want:
        w = want[name].numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-3,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_params_after_adam_match(both_steps):
    want, got = both_steps["params"]
    assert both_steps["step"] == (1, 1)
    assert both_steps["moved"] == len(want), "every tensor takes an update"
    grads = both_steps["grads"][0]
    for name in want:
        off = np.abs(got[name].numpy() - want[name].numpy()) > 1e-5
        sure = np.abs(grads[name].numpy()) >= 1e-5
        assert not (off & sure).any(), name
        assert off.sum() <= 1e-4 * off.size, f"{name}: {off.sum()} entries differ"


@pytest.mark.parametrize("field", LGVaeOutput._fields)
def test_eval_outputs_match(both_steps, field):
    j_out, t_out = both_steps["eval_out"]
    got = getattr(t_out, field)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(j_out, field)), rtol=1e-4,
                               atol=1e-4, err_msg=field)


def test_unported_families_raise():
    """bfloat16 is ported: the step is made, and refuses a model built in the
    other compute dtype (the intent of the JAX package's
    ``_check_activation_dtype``); an unknown dtype raises when the model is built."""
    cfg = PortConfig(global_latent_dims=4, local_latent_dims=4, patch_size=4)
    state = torch_state(torch_model(cfg, (16, 16), device="cpu"), vae_optimizer(1e-4))
    batch = torch.zeros((2, 16, 16, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="compute dtype mismatch"):
        torch_step(cfg.replace(compute_dtype="bfloat16"))(state, batch)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        torch_model(cfg.replace(compute_dtype="float16"), (16, 16), device="cpu")
