"""The LGVae modules of the port against the JAX package: ConvEncoder,
ConvDecoder, LGVae (forward, encode, decode) and lgvae_loss.

The JAX side initialises the parameters; the port gets them through
``interop/flax_params.py`` and the normals that the JAX encoders drew
(recorded by wrapping ``reparameterize`` where ``nn/encoders.py`` binds it).
Outputs agree at rtol 1e-4, atol 1e-4 (fp32 convolutions on the CPU in another
order; the JAX decoder's last layer is the fused resize+conv, the port's the
chain it equals), the loss's metrics at rtol 1e-4.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import split_vae_tpu.nn.encoders as jax_encoders  # noqa: E402
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.interop.flax_params import load_flax_params  # noqa: E402
from split_vae_torch.models.vae import LGVae as TorchLGVae  # noqa: E402
from split_vae_torch.models.vae import LGVaeOutput as TorchOutput  # noqa: E402
from split_vae_torch.nn.decoders import ConvDecoder as TorchDecoder  # noqa: E402
from split_vae_torch.nn.encoders import ConvEncoder as TorchEncoder  # noqa: E402
from split_vae_torch.train.losses import lgvae_loss as torch_loss  # noqa: E402
from split_vae_tpu.models.vae import LGVae as JaxLGVae  # noqa: E402
from split_vae_tpu.models.vae import LGVaeOutput as JaxOutput  # noqa: E402
from split_vae_tpu.nn.decoders import ConvDecoder as JaxDecoder  # noqa: E402
from split_vae_tpu.train.losses import lgvae_loss as jax_loss  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# (image size, global latents, local latents): an SVHN shape and a CelebA64 shape.
SHAPES = {"svhn32": ((32, 32), 16, 12), "celeba64": ((64, 64), 8, 8)}
B = 3


def _record(mp):
    """Keeps the normals of every reparameterize call of the JAX encoders, in call order."""
    draws = []
    orig = jax_encoders.reparameterize

    def reparameterize(key, mean, sigma):
        draws.append(np.array(jax.random.normal(key, sigma.shape, dtype=sigma.dtype)))
        return orig(key, mean, sigma)

    mp.setattr(jax_encoders, "reparameterize", reparameterize)
    return draws


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("hw,latent", [((32, 32), 8), ((64, 64), 16), ((24, 40), 4)])
def test_conv_encoder_matches(monkeypatch, hw, latent):
    x = np.random.RandomState(0).uniform(-1, 1, (B, *hw, 3)).astype(np.float32)
    model = jax_encoders.ConvEncoder(latent)
    rngs = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    params = model.init(rngs, jnp.asarray(x))["params"]
    draws = _record(monkeypatch)
    want = model.apply({"params": params}, jnp.asarray(x), rngs={"sample": jax.random.PRNGKey(5)})
    port = load_flax_params(TorchEncoder(hw, 3, latent, "cpu"), _np_tree(params))
    noise = Noise(torch.Generator(), draws)
    got = port(torch.from_numpy(x), noise)
    assert noise.exhausted() and len(draws) == 1
    for name, g, w in zip(("z", "z_mean", "z_sig"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), err_msg=name, **TOL)
    assert (got[2] > 0).all()


# Square sizes only: the JAX decoder's fused last layer takes no other.
@pytest.mark.parametrize("hw,latent", [((32, 32), 8), ((64, 64), 16), ((48, 48), 4)])
def test_conv_decoder_matches(hw, latent):
    z = np.random.RandomState(1).randn(B, latent).astype(np.float32)
    cot = np.random.RandomState(2).randn(B, *hw, 6).astype(np.float32)
    model = JaxDecoder(hw)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"]

    def jax_fn(p, zz):
        return jnp.concatenate(model.apply({"params": p}, zz), axis=-1)

    want = jax_fn(params, jnp.asarray(z))
    jg = jax.grad(lambda zz: jnp.sum(jax_fn(params, zz) * cot))(jnp.asarray(z))
    port = load_flax_params(TorchDecoder(latent, hw, 6, "cpu"), _np_tree(params))
    tz = torch.tensor(z, requires_grad=True)
    mean, log_scale = port(tz)
    got = torch.cat([mean, log_scale], dim=-1)
    assert tuple(mean.shape) == (B, *hw, 3) == tuple(log_scale.shape)
    (g,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(cot)), tz)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-3,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())


@pytest.fixture(scope="module", params=sorted(SHAPES))
def both_models(request):
    """The JAX LGVae and the port's with its parameters, one forward each on
    the same inputs and normals, and both losses."""
    hw, g_dims, l_dims = SHAPES[request.param]
    mp = pytest.MonkeyPatch()
    try:
        images = np.random.RandomState(3).uniform(-1, 1, (B, *hw, 6)).astype(np.float32)
        model = JaxLGVae(g_dims, l_dims, hw)
        rngs = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
        params = model.init(rngs, jnp.asarray(images))["params"]
        draws = _record(mp)
        sample = {"sample": jax.random.PRNGKey(7)}
        j_out = model.apply({"params": params}, jnp.asarray(images), True, rngs=sample)
        forward_draws = list(draws)
        j_z = model.apply({"params": params}, jnp.asarray(images), rngs=sample,
                          method=JaxLGVae.encode)
        encode_draws = draws[len(forward_draws):]
        j_dec = [model.apply({"params": params}, *j_z, r, method=JaxLGVae.decode)
                 for r in (True, False)]

        port = load_flax_params(TorchLGVae(g_dims, l_dims, hw, device="cpu"), _np_tree(params))
        t_images = torch.from_numpy(images)
        noise = Noise(torch.Generator(), forward_draws)
        t_out = port(t_images, True, noise)
        assert noise.exhausted() and len(forward_draws) == 2
        with torch.no_grad():
            t_z = port.encode(t_images, Noise(torch.Generator(), encode_draws))
            t_dec = [port.decode(*t_z, rescale=r) for r in (True, False)]
        return dict(out=(j_out, t_out), z=(j_z, t_z), dec=(j_dec, t_dec),
                    loss=(jax_loss(j_out, jnp.asarray(images), 30.0),
                          torch_loss(t_out, t_images, 30.0)))
    finally:
        mp.undo()


def test_output_fields_are_the_jax_package_s():
    assert TorchOutput._fields == JaxOutput._fields


@pytest.mark.parametrize("field", JaxOutput._fields)
def test_lgvae_forward_matches(both_models, field):
    j_out, t_out = both_models["out"]
    np.testing.assert_allclose(getattr(t_out, field).detach().numpy(),
                               np.asarray(getattr(j_out, field)), err_msg=field, **TOL)


def test_lgvae_encode_decode_match(both_models):
    for want, got in zip(both_models["z"][0], both_models["z"][1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for (j_x, j_xh), (t_x, t_xh) in zip(*both_models["dec"]):
        np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), **TOL)
        np.testing.assert_allclose(t_xh.numpy(), np.asarray(j_xh), **TOL)
    rescaled = both_models["dec"][1][0][0]
    assert rescaled.min() >= 0.0 and rescaled.max() <= 1.0


def test_lgvae_loss_metrics_match(both_models):
    (j_total, j_metrics), (t_total, t_metrics) = both_models["loss"]
    assert sorted(t_metrics) == sorted(j_metrics)
    np.testing.assert_allclose(float(t_total), float(j_total), rtol=1e-4)
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=1e-4,
                                   err_msg=k)
