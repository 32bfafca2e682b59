"""The step's small helpers against the JAX package: the three anneals of
train/schedules.py (f32 arithmetic on the step counter, rtol 1e-6) and
normalize_images (uint8 and float batches, exact)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from split_vae_torch.train import schedules as ts  # noqa: E402
from split_vae_torch.train.steps import normalize_images as torch_normalize  # noqa: E402
from split_vae_tpu.train import schedules as js  # noqa: E402
from split_vae_tpu.train.steps import normalize_images as jax_normalize  # noqa: E402

STEPS = [0, 1, 499, 4999, 9998, 9999, 10_000, 123_457, 10**6]


@pytest.mark.parametrize("step", STEPS)
def test_anneals_match(step):
    s = jnp.float32(step)
    pairs = [
        (ts.z_pres_prior_prob(step, 10_000.0), js.z_pres_prior_prob(s, 10_000.0)),
        (ts.z_zoom_prior_mean(step, 0.0, 10.0, 10_000.0),
         js.z_zoom_prior_mean(s, 0.0, 10.0, 10_000.0)),
        (ts.z_zoom_prior_mean(step, -1.5, 4.0, 3_000.0),
         js.z_zoom_prior_mean(s, -1.5, 4.0, 3_000.0)),
        (ts.beta_warmup(step, 2.0, 1000.0), js.beta_warmup(s, 2.0, 1000.0)),
        (ts.beta_warmup(step, 0.5, 1.0), js.beta_warmup(s, 0.5, 1.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got, float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["unit", "tanh"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_images_matches(mode, dtype):
    rng = np.random.RandomState(3)
    batch = (rng.randint(0, 256, (2, 8, 8, 3)) if dtype == np.uint8
             else rng.uniform(0, 1, (2, 8, 8, 3))).astype(dtype)
    got = torch_normalize(torch.from_numpy(batch), mode)
    want = np.asarray(jax_normalize(jnp.asarray(batch), mode))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
