"""The SPAIR eval step of the port against the JAX package's, with labels.

``make_spair_eval_step`` keeps the reference's quirks on both sides: the model
runs with training=True and the unfused render (so the Concrete sample and the
render's N(0, 0.01) noise stay on), the loss with training=False at step 0.
The JAX step is jitted, so its draws are recorded first from the same keys
outside jit (``jax.random.split(rng)`` as the step splits it) and replayed in
the port. Held for BG-SPAIR and LG-SPAIR at the small shape of
tests/test_torch_spair_family.py: the metric keys as sets, every value at
rtol 1e-4, the outputs at atol/rtol 1e-4. ``count_metrics`` is held on
hand-made counts with a zero label: the 1e-7 denominator of ``MAPE test`` and
``MAPE_nonzero test`` beside it.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_spair_family import B, HW, record_draws, small_configs  # noqa: E402

import split_vae_tpu.models.spair as jax_spair  # noqa: E402
import split_vae_tpu.ops.patches as jax_patches  # noqa: E402
from split_vae_torch.interop.flax_params import load_flax_params  # noqa: E402
from split_vae_torch.models.spair import get_spair_model as torch_model  # noqa: E402
from split_vae_torch.train.steps import count_metrics as torch_count_metrics  # noqa: E402
from split_vae_torch.train.steps import make_spair_eval_step as torch_eval  # noqa: E402
from split_vae_tpu.train.steps import count_metrics as jax_count_metrics  # noqa: E402
from split_vae_tpu.train.steps import make_spair_eval_step as jax_eval  # noqa: E402


@pytest.fixture(scope="module", params=["bg_spair", "lg_spair_conv"])
def both_evals(request):
    mp = pytest.MonkeyPatch()
    try:
        jax_cfg, port_cfg = small_configs(request.param)
        lg = jax_cfg.model == "lg_spair"
        rng = np.random.RandomState(21)
        x = rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)
        labels = np.array([0.0, 4.0, 2.0, 3.0], np.float32)

        model = jax_spair.get_spair_model(jax_cfg)
        params = model.init({"params": jax.random.PRNGKey(8), "sample": jax.random.PRNGKey(9)},
                            jnp.zeros((B, HW, HW, 6 if lg else 3)), training=True)["params"]
        key = jax.random.PRNGKey(10)
        k_aug, k_sample = jax.random.split(key)
        draws = record_draws(mp)
        images = jnp.asarray(x)
        if lg:
            images = jax_patches.augment_batch(k_aug, images, "scramble", jax_cfg.patch_size)
        model.apply({"params": params}, images, True, fused=False, rngs={"sample": k_sample})
        replay = list(draws)
        mp.undo()
        j_out, j_metrics, j_images = jax_eval(jax_cfg, model.apply)(
            params, key, jnp.asarray(x), jnp.asarray(labels))

        tmodel = torch_model(port_cfg, device="cpu")
        load_flax_params(tmodel, jax.tree.map(np.array, params))
        before = [p.detach().clone() for p in tmodel.parameters()]
        t_out, t_metrics, t_images = torch_eval(port_cfg, tmodel)(
            torch.Generator().manual_seed(0), torch.from_numpy(x), torch.from_numpy(labels),
            replay)
        assert all(torch.equal(a, b) for a, b in zip(before, tmodel.parameters()))
        return dict(out=(j_out, t_out), metrics=(j_metrics, t_metrics),
                    images=(np.asarray(j_images), t_images.numpy()))
    finally:
        mp.undo()


def test_eval_metric_keys_are_the_same_set(both_evals):
    want, got = both_evals["metrics"]
    assert set(got) == set(want)
    assert {"MAE test", "MAPE test", "MAPE_nonzero test", "count_acc", "total_loss"} <= set(got)


def test_eval_metric_values_match(both_evals):
    want, got = both_evals["metrics"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)


def test_eval_images_match(both_evals):
    want, got = both_evals["images"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("field", ["x_recon", "z_pres", "z_pres_logits", "z_where",
                                   "obj_full_recon_unnorm", "obj_bbox_mask", "z_bg_mean"])
def test_eval_outputs_match(both_evals, field):
    j_out, t_out = both_evals["out"]
    want, got = getattr(j_out, field), getattr(t_out, field)
    assert want is not None and got is not None and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4,
                               err_msg=field)


@pytest.mark.parametrize("pred,labels", [
    ([1.0, 3.0, 2.0, 0.0], [0.0, 3.0, 4.0, 1.0]),   # a zero label: the 1e9 quirk
    ([2.0, 2.0, 5.0], [2.0, 1.0, 4.0]),
    ([0.0, 1.0], [0.0, 0.0]),                        # no image with objects at all
])
def test_count_metrics(pred, labels):
    pred, labels = np.array(pred, np.float32), np.array(labels, np.float32)
    want = jax_count_metrics(jnp.asarray(pred), jnp.asarray(labels))
    got = torch_count_metrics(torch.from_numpy(pred), torch.from_numpy(labels))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    if (labels == 0).any() and (pred != labels)[labels == 0].any():
        assert float(got["MAPE test"]) > 1e8  # err / 1e-7 * 100 in the mean
    if (labels > 0).any():
        nz = labels > 0
        np.testing.assert_allclose(
            float(got["MAPE_nonzero test"]),
            np.mean(np.abs(labels - pred)[nz] / labels[nz] * 100.0), rtol=1e-6)
    else:
        assert float(got["MAPE_nonzero test"]) == 0.0
