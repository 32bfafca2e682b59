"""The GM families of the port against the JAX package: GMVaeEncoder,
FCEncoder, LGGMVae and GMVae (forward with training on and off, encode,
decode, encode_y, get_y), lggmvae_loss and gmvae_loss, one train step and one
eval step of each GM model, gm_lr_schedule and AMSGrad.

Small shapes: SVHN 32x32, latents 8, y_size 5, B=4. The JAX side initialises
the parameters; the port gets them through ``interop/flax_params.py``. The
JAX draws are recorded by wrapping ``gumbel_softmax`` and ``reparameterize``
where ``split_vae_tpu.nn.encoders`` binds them (the 'sample' stream),
``batched_scramble`` where ``ops/patches.py`` binds it, and
``flax.linen.Dropout.__call__`` (the 'dropout' stream's keep masks), and
replayed to the port in its order: the scramble's uniforms, the sample draws,
then the keep masks.

Held: outputs at atol/rtol 1e-4; metrics rtol 1e-4; gradients rtol 1e-3,
atol 1e-6 max|g|; parameters after Adam atol 1e-5 where |g| >= 1e-5 (see
``test_torch_vae_step.py`` for why); the schedule at rtol 1e-6; AMSGrad's
updates at rtol 1e-5, atol 1e-10.

The step's gradients are held in float64 on both sides, on the same draws.
In float32 the y block's gradients (``y_dense1``, ``y_dense2``, ``e1``) lie
as far from the float64 gradient in the JAX package as in the port, up to 2.3
times that tolerance: the backward of the Gumbel softmax at tau 0.4, p (dy -
sum p dy), cancels, and so does the batch sum of their weight gradients.
Everything else of the step is held in float32.
"""

import pytest

torch = pytest.importorskip("torch")

import flax.linen as flax_nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import split_vae_tpu.nn.common as jax_common  # noqa: E402
import split_vae_tpu.nn.encoders as jax_encoders  # noqa: E402
import split_vae_tpu.ops.patches as jax_patches  # noqa: E402
from split_vae_torch.core.config import VaeConfig as PortConfig  # noqa: E402
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.core.state import create_train_state as torch_state  # noqa: E402
from split_vae_torch.interop.flax_params import flax_to_state_dict, load_flax_params  # noqa: E402
from split_vae_torch.models.vae import get_vae_model as torch_model  # noqa: E402
from split_vae_torch.nn import encoders as torch_encoders  # noqa: E402
from split_vae_torch.train import losses as torch_losses  # noqa: E402
from split_vae_torch.train.optim import adam, gm_optimizer  # noqa: E402
from split_vae_torch.train.schedules import gm_lr_schedule  # noqa: E402
from split_vae_torch.train.steps import augment as torch_augment  # noqa: E402
from split_vae_torch.train.steps import make_vae_eval_step as torch_eval  # noqa: E402
from split_vae_torch.train.steps import make_vae_train_step as torch_step  # noqa: E402
from split_vae_torch.train.steps import normalize_images as torch_normalize  # noqa: E402
from split_vae_tpu.core.config import VaeConfig  # noqa: E402
from split_vae_tpu.core.state import create_train_state as jax_state  # noqa: E402
from split_vae_tpu.models.vae import GMVae, GMVaeOutput, LGGMVae, LGGMVaeOutput  # noqa: E402
from split_vae_tpu.train import losses as jax_losses  # noqa: E402
from split_vae_tpu.train import schedules as jax_schedules  # noqa: E402
from split_vae_tpu.train.loop import build_vae_model  # noqa: E402
from split_vae_tpu.train.steps import make_vae_eval_step as jax_eval  # noqa: E402
from split_vae_tpu.train.steps import make_vae_train_step as jax_step  # noqa: E402
from split_vae_tpu.train.steps import normalize_images  # noqa: E402

B, HW, LATENT, Y = 4, (32, 32), 8, 5
TOL = dict(rtol=1e-4, atol=1e-4)
OUTPUTS = {"lggmvae": LGGMVaeOutput, "gmvae": GMVaeOutput}


class Recorder:
    """Wraps the JAX samplers; ``sample`` and ``masks`` keep the draws in call order."""

    def __init__(self, mp):
        self.sample, self.masks, self.scramble = [], [], []
        orig_gumbel, orig_reparam = jax_encoders.gumbel_softmax, jax_encoders.reparameterize
        orig_scramble, orig_dropout = jax_patches.batched_scramble, flax_nn.Dropout.__call__

        def gumbel_softmax(key, logits, tau, eps=0.0):
            self.sample.append(np.array(jax.random.uniform(key, logits.shape, dtype=logits.dtype,
                                                           minval=eps)))
            return orig_gumbel(key, logits, tau, eps)

        def reparameterize(key, mean, sigma):
            self.sample.append(np.array(jax.random.normal(key, sigma.shape, dtype=sigma.dtype)))
            return orig_reparam(key, mean, sigma)

        def scramble(key, x, size):
            b, h, w, _ = x.shape
            self.scramble.append(np.array(jax.random.uniform(key, (b, (h // size) * (w // size)))))
            return orig_scramble(key, x, size)

        def dropout(module, inputs, deterministic=None, rng=None):
            det = module.deterministic if deterministic is None else deterministic
            if not det and module.rate > 0.0:
                if rng is None:
                    rng = module.make_rng(module.rng_collection)
                self.masks.append(np.array(jax.random.bernoulli(rng, 1.0 - module.rate,
                                                                inputs.shape)))
            return orig_dropout(module, inputs, deterministic, rng)

        mp.setattr(jax_encoders, "gumbel_softmax", gumbel_softmax)
        mp.setattr(jax_encoders, "reparameterize", reparameterize)
        mp.setattr(jax_patches, "batched_scramble", scramble)
        mp.setattr(flax_nn.Dropout, "__call__", dropout)

    def take(self):
        """The draws so far in the port's order, then forget them."""
        out = self.scramble + self.sample + self.masks
        self.sample, self.masks, self.scramble = [], [], []
        return out


def _jax_grads_float64(apply_fn, params, images, sample, masks, loss_of, cfg):
    """The JAX loss's gradients in float64 on the recorded float32 draws."""
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(True):
            mp.setattr(jax_common, "_ACTIVATION_DTYPE", jnp.float64)
            sample, masks = list(sample), list(masks)

            def gumbel_softmax(key, logits, tau, eps=0.0):
                g = -jnp.log(-jnp.log(jnp.asarray(sample.pop(0), jnp.float64)))
                return jax.nn.softmax((logits + g) / tau, axis=-1)

            def reparameterize(key, mean, sigma):
                return mean + sigma * jnp.asarray(sample.pop(0), jnp.float64)

            def dropout(module, inputs, deterministic=None, rng=None):
                det = module.deterministic if deterministic is None else deterministic
                if det:
                    return inputs
                return jnp.where(masks.pop(0), inputs / (1.0 - module.rate), 0.0)

            mp.setattr(jax_encoders, "gumbel_softmax", gumbel_softmax)
            mp.setattr(jax_encoders, "reparameterize", reparameterize)
            mp.setattr(flax_nn.Dropout, "__call__", dropout)
            p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
            x64 = jnp.asarray(np.asarray(images), jnp.float64)
            keys = {"sample": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}

            def loss(p):
                out = apply_fn({"params": p}, x64, True, rngs=keys)
                return loss_of(out, x64, cfg.beta, cfg.alpha, cfg.y_size)[0]

            grads = _np(jax.grad(loss)(p64))
            assert not sample and not masks
            return grads
    finally:
        mp.undo()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(seed=0, channels=6):
    return np.random.RandomState(seed).uniform(-1, 1, (B, *HW, channels)).astype(np.float32)


def _jax_model(kind):
    if kind == "lggmvae":
        return LGGMVae(LATENT, LATENT, HW, Y, 0.4)
    return GMVae(LATENT, HW, Y, 0.4)


def _port_config(kind, **kw):
    return PortConfig(model=kind, global_latent_dims=LATENT, local_latent_dims=LATENT, y_size=Y,
                      batch_size=B, patch_size=4, **kw)


@pytest.fixture(scope="module", params=sorted(OUTPUTS))
def models(request):
    """(kind, the JAX model, its params, the port model with them)."""
    kind = request.param
    model = _jax_model(kind)
    variables = model.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
                            "dropout": jax.random.PRNGKey(2)}, jnp.zeros((B, *HW, 6)), True)
    params = _np(variables["params"])
    port = load_flax_params(torch_model(_port_config(kind), HW, device="cpu"), params)
    return kind, model, params, port


def _assert_tuple(got, want, fields):
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).detach().numpy(), np.asarray(getattr(want, f)),
                                   **TOL, err_msg=f)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_gm_encoder_forward_matches(monkeypatch, training):
    enc = jax_encoders.GMVaeEncoder(LATENT, Y, 0.4)
    x = _inputs(channels=3)
    variables = enc.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                         jnp.asarray(x))
    rec = Recorder(monkeypatch)
    want = enc.apply(variables, jnp.asarray(x), training,
                     rngs={"sample": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)})
    replay = rec.take()
    assert len(replay) == (4 if training else 2)
    port = load_flax_params(torch_encoders.GMVaeEncoder(HW, 3, LATENT, Y, 0.4),
                            _np(variables["params"]))
    noise = Noise(torch.Generator(), replay)
    got = port(torch.from_numpy(x), training, noise)
    assert noise.exhausted()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    y = np.random.RandomState(5).uniform(0, 1, (B, Y)).astype(np.float32)
    for g, w in zip(port.encode_y(torch.from_numpy(y)),
                    enc.apply(variables, jnp.asarray(y), method="encode_y")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_gm_encoder_sigma_heads_start_at_one():
    """The two sigma heads' biases start at 1 (ones_bias), every other Dense at 0."""
    cfg = _port_config("lggmvae")
    enc = torch_model(cfg, HW, device="cpu").encoder_x
    for name in ("z_prior_sig_head", "z_sig_head"):
        assert torch.equal(getattr(enc, name).bias, torch.ones(LATENT))
    for name in ("y_dense1", "y_dense2", "y_head", "h_top_dense", "z_prior_mean_head", "e1",
                 "z_mean_head", "h_conv1"):
        assert not getattr(enc, name).bias.any(), name
    variables = jax_encoders.GMVaeEncoder(LATENT, Y, 0.4).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((B, *HW, 3)))
    sd = flax_to_state_dict(_np(variables["params"]), enc)
    assert all(torch.equal(sd[n + ".bias"], getattr(enc, n).bias) for n in
               ("z_prior_sig_head", "z_sig_head", "y_head"))


@pytest.mark.parametrize("variational", [True, False])
def test_fc_encoder_matches(monkeypatch, variational):
    enc = jax_encoders.FCEncoder(LATENT, variational)
    x = _inputs(channels=3)
    variables = enc.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                         jnp.asarray(x))
    rec = Recorder(monkeypatch)
    want = enc.apply(variables, jnp.asarray(x), rngs={"sample": jax.random.PRNGKey(3)})
    port = load_flax_params(torch_encoders.FCEncoder(HW[0] * HW[1] * 3, LATENT, variational),
                            _np(variables["params"]))
    got = port(torch.from_numpy(x), Noise(torch.Generator(), rec.take()))
    if not variational:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_forward_and_loss_match(models, monkeypatch, training):
    kind, model, params, port = models
    x = _inputs()
    rec = Recorder(monkeypatch)
    want = model.apply({"params": params}, jnp.asarray(x), training,
                       rngs={"sample": jax.random.PRNGKey(7), "dropout": jax.random.PRNGKey(8)})
    replay = rec.take()
    assert len(replay) == (2 if kind == "gmvae" else 3) + (2 if training else 0)
    noise = Noise(torch.Generator(), replay)
    got = port(torch.from_numpy(x), training, noise)
    assert noise.exhausted() and type(got).__name__ == type(want).__name__
    assert got._fields == OUTPUTS[kind]._fields
    _assert_tuple(got, want, got._fields)
    jax_fn = jax_losses.lggmvae_loss if kind == "lggmvae" else jax_losses.gmvae_loss
    port_fn = torch_losses.lggmvae_loss if kind == "lggmvae" else torch_losses.gmvae_loss
    _, w_metrics = jax_fn(want, jnp.asarray(x), 40.0, 30.0, Y)
    _, g_metrics = port_fn(got, torch.from_numpy(x), 40.0, 30.0, Y)
    assert sorted(g_metrics) == sorted(w_metrics)
    assert "y_kl_loss" in g_metrics
    for k in w_metrics:
        np.testing.assert_allclose(float(g_metrics[k]), float(w_metrics[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_encode_decode_encode_y_get_y_match(models, monkeypatch):
    kind, model, params, port = models
    x = _inputs(1)
    rec = Recorder(monkeypatch)
    variables = {"params": params}
    want_z = model.apply(variables, jnp.asarray(x), method="encode",
                         rngs={"sample": jax.random.PRNGKey(9)})
    got_z = port.encode(torch.from_numpy(x), Noise(torch.Generator(), rec.take()))
    if kind == "gmvae":
        want_z, got_z = (want_z,), (got_z,)
    for g, w in zip(got_z, want_z):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)

    for rescale in (True, False):
        want = model.apply(variables, *want_z, rescale=rescale, method="decode")
        got = port.decode(*[torch.from_numpy(np.asarray(z)) for z in want_z], rescale=rescale)
        if kind == "gmvae":
            want, got = (want,), (got,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
            if rescale:
                assert 0.0 <= float(g.min()) and float(g.max()) <= 1.0

    y = np.eye(Y, dtype=np.float32)[np.arange(B) % Y]
    for g, w in zip(port.encode_y(torch.from_numpy(y)),
                    model.apply(variables, jnp.asarray(y), method="encode_y")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)

    want_y = model.apply(variables, jnp.asarray(x), method="get_y",
                         rngs={"sample": jax.random.PRNGKey(10)})
    got_y = port.get_y(torch.from_numpy(x), Noise(torch.Generator(), rec.take()))
    for g, w in zip(got_y, want_y):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.fixture(scope="module", params=sorted(OUTPUTS))
def both_steps(request):
    """One JAX train step and eval step of a GM model (as ``train/loop.py``
    builds it) and the port's on converted parameters and replayed draws."""
    kind = request.param
    port_cfg = _port_config(kind)
    jax_cfg = VaeConfig(**port_cfg.__dict__)
    mp = pytest.MonkeyPatch()
    try:
        batch = np.random.RandomState(0).randint(0, 255, (B, *HW, 3)).astype(np.uint8)
        model, tx = build_vae_model(jax_cfg, HW)
        state = jax_state(model, jnp.zeros((B, *HW, 6)), tx, seed=3,
                          training_kwargs={"training": True})
        params0 = _np(state.params)
        _, (k_aug, k_sample, k_drop) = state.next_rng(3)

        rec = Recorder(mp)
        x = normalize_images(jnp.asarray(batch), "tanh")
        images = jax_patches.augment_batch(k_aug, x, jax_cfg.augmentation, jax_cfg.patch_size)
        loss_of = jax_losses.lggmvae_loss if kind == "lggmvae" else jax_losses.gmvae_loss

        def loss(p):
            out = state.apply_fn({"params": p}, images, True,
                                 rngs={"sample": k_sample, "dropout": k_drop})
            return loss_of(out, images, jax_cfg.beta, jax_cfg.alpha, jax_cfg.y_size)

        (_, j_metrics), j_grads = jax.value_and_grad(loss, has_aux=True)(state.params)
        sample, masks = list(rec.sample), list(rec.masks)
        replay = rec.take()
        eval_rng = jax.random.PRNGKey(11)
        e_aug, e_sample = jax.random.split(eval_rng)
        e_images = jax_patches.augment_batch(e_aug, x, jax_cfg.augmentation, jax_cfg.patch_size)
        state.apply_fn({"params": state.params}, e_images, False, rngs={"sample": e_sample})
        eval_replay = rec.take()
        mp.undo()  # the jitted steps draw the same numbers from the same keys
        j_eval_out, j_eval_metrics, _ = jax_eval(jax_cfg, state.apply_fn)(
            state.params, eval_rng, jnp.asarray(batch))
        new_state, j_step_metrics = jax_step(jax_cfg)(state, jnp.asarray(batch))

        tmodel = load_flax_params(torch_model(port_cfg, HW, device="cpu"), params0)
        tbatch = torch.from_numpy(batch)
        t_eval_out, t_eval_metrics, _ = torch_eval(port_cfg, tmodel)(
            torch.Generator(), tbatch, eval_replay)
        names = [n for n, _ in tmodel.named_parameters()]
        tstate = torch_state(tmodel, gm_optimizer(port_cfg.learning_rate), seed=0)
        tstate, t_step_metrics = torch_step(port_cfg)(tstate, tbatch, replay)
        # The gradients in float64, from the same scrambled images and draws.
        j_grads64 = _jax_grads_float64(state.apply_fn, params0, images, sample, masks, loss_of,
                                       jax_cfg)
        fresh = load_flax_params(torch_model(port_cfg, HW, device="cpu"), params0).double()
        f_images = torch.from_numpy(np.asarray(images, np.float64))
        f_out = fresh(f_images, True, Noise(torch.Generator(), sample + masks,
                                            dtype=torch.float64))
        port_loss = (torch_losses.lggmvae_loss if kind == "lggmvae"
                     else torch_losses.gmvae_loss)
        f_total, _ = port_loss(f_out, f_images, port_cfg.beta, port_cfg.alpha, port_cfg.y_size)
        t_grads = torch.autograd.grad(f_total, list(fresh.parameters()))
        return dict(
            kind=kind,
            metrics=(j_metrics, t_step_metrics),
            step_metrics=(j_step_metrics, t_step_metrics),
            grads32=flax_to_state_dict(_np(j_grads), tmodel),
            grads=(flax_to_state_dict(j_grads64, fresh), dict(zip(names, t_grads))),
            params=(flax_to_state_dict(_np(new_state.params), tmodel), tmodel.state_dict()),
            step=(int(new_state.step), tstate.step),
            eval_out=(j_eval_out, t_eval_out),
            eval_metrics=(j_eval_metrics, t_eval_metrics),
        )
    finally:
        mp.undo()


@pytest.mark.parametrize("which", ["metrics", "step_metrics", "eval_metrics"])
def test_step_metrics_match(both_steps, which):
    want, got = both_steps[which]
    if which == "metrics":  # the unjitted JAX loss has no optimizer column
        got = {k: v for k, v in got.items() if k != "notfinite_updates"}
    assert sorted(got) == sorted(want) and "y_kl_loss" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_step_gradients_match(both_steps):
    want, got = both_steps["grads"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert want[name].dtype == got[name].dtype == torch.float64
        w = want[name].numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-3,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_step_params_after_adam_match(both_steps):
    want, got = both_steps["params"]
    assert both_steps["step"] == (1, 1)
    grads = both_steps["grads32"]
    for name in want:
        off = np.abs(got[name].numpy() - want[name].numpy()) > 1e-5
        sure = np.abs(grads[name].numpy()) >= 1e-5
        assert not (off & sure).any(), name
        assert off.sum() <= 1e-4 * off.size, f"{name}: {off.sum()} entries differ"


def test_eval_step_outputs_match(both_steps):
    j_out, t_out = both_steps["eval_out"]
    assert not t_out.x_mean.requires_grad
    _assert_tuple(t_out, j_out, OUTPUTS[both_steps["kind"]]._fields)


@pytest.mark.parametrize("count", [0, 999_999, 1_000_000, 2_500_000])
def test_gm_lr_schedule_matches(count):
    want = float(jax_schedules.gm_lr_schedule(3e-4)(jnp.asarray(count, jnp.int32)))
    got = gm_lr_schedule(3e-4)(torch.tensor(count, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_schedule_is_read_before_the_count_moves():
    """The update at count c uses lr(c), as optax's scale_by_schedule does."""
    g = [torch.ones(3)]
    tx = adam(lambda count: 1e-3 * (count.to(torch.float32) + 1.0))
    state = tx.init(g)
    for count in range(3):
        updates, state = tx.update(g, state)
        # Adam's updates on a constant gradient are -lr / (1 + eps), up to the
        # float32 rounding of the bias corrections (1 - 0.999^t cancels).
        np.testing.assert_allclose(updates[0].numpy(), -1e-3 * (count + 1), rtol=1e-4)
    assert int(state.count) == 3


def test_amsgrad_matches_optax():
    """Five updates of adam(amsgrad=True) against optax.amsgrad(1e-4, eps=1e-7).
    The gradients shrink and grow so that the maximum of the bias-corrected
    second moment is held, not the raw one."""
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,)]
    scales = [1.0, 0.1, 0.01, 3.0, 0.5]
    grads = [[(s * rng.randn(*shape)).astype(np.float32) for shape in shapes] for s in scales]
    params = [np.zeros(shape, np.float32) for shape in shapes]
    tx = optax.amsgrad(1e-4, eps=1e-7)
    j_state = tx.init([jnp.asarray(p) for p in params])
    t_tx = adam(1e-4, amsgrad=True)
    t_state = t_tx.init([torch.from_numpy(p) for p in params])
    for g in grads:
        want, j_state = tx.update([jnp.asarray(x) for x in g], j_state)
        got, t_state = t_tx.update([torch.from_numpy(x) for x in g], t_state)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-10)



def test_torch_optim_amsgrad_is_not_optax_amsgrad():
    """torch.optim.Adam(amsgrad=True) keeps the maximum of the raw second
    moment: on a gradient that shrinks, its second update already differs."""
    g1, g2 = np.float32(1.0), np.float32(0.01)
    p = torch.zeros(1, requires_grad=True)
    opt = torch.optim.Adam([p], lr=1e-4, eps=1e-7, amsgrad=True)
    t_tx = adam(1e-4, amsgrad=True)
    state = t_tx.init([torch.zeros(1)])
    ours = torch.zeros(1)
    for g in (g1, g2):
        p.grad = torch.full((1,), float(g))
        opt.step()
        updates, state = t_tx.update([torch.full((1,), float(g))], state)
        ours += updates[0]
    assert not torch.allclose(p.detach(), ours, rtol=1e-3, atol=0.0)
