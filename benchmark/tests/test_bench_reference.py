"""The frozen reference against the port at a tiny size, piece by piece, and
its FLOP count against a hand count."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import common


def test_render_noise_is_the_kernels_philox():
    from split_vae_torch.kernels.render import render_noise_reference
    seed, b, k, c, h, w = 2**31 - 5, 3, 4, 3, 5, 6
    ours = common.render_noise(seed, b, k, c, h, w, "cpu").permute(0, 1, 4, 2, 3)
    np.testing.assert_allclose(ours.numpy(), render_noise_reference(seed, b, k, c, h, w),
                               rtol=2e-6, atol=2e-6)


def test_crop_and_paste_taps_match_the_dense_forms():
    from split_vae_torch.ops.stn import stn_crop, stn_paste
    g = torch.Generator().manual_seed(3)
    img = torch.rand((2, 24, 24, 3), generator=g)
    z_where = 2.0 * torch.randn((2, 2, 2, 4), generator=g)
    glimpses, _ = stn_crop(img, z_where, (16, 16))
    torch.testing.assert_close(common.crop(img, z_where, 16), glimpses, rtol=1e-5, atol=1e-6)
    objs = torch.rand((2, 4, 16, 16, 4), generator=g)
    canvases, _ = stn_paste(objs, z_where, (24, 24))
    torch.testing.assert_close(common.paste(objs, z_where, (24, 24)), canvases,
                               rtol=1e-5, atol=1e-6)


def test_init_is_by_name_not_order():
    a = common.init_weights({"x.weight": (4, 3), "x.bias": (4,), "a.weight": (2, 2, 3, 3)}, 7,
                            "cpu")
    b = common.init_weights({"a.weight": (2, 2, 3, 3), "x.bias": (4,), "x.weight": (4, 3)}, 7,
                            "cpu")
    for n in a:
        assert torch.equal(a[n], b[n])
    assert torch.equal(a["x.bias"], torch.zeros(4))
    assert float(a["x.weight"].abs().max()) <= np.sqrt(6.0 / 7.0)


def test_flop_count_by_hand():
    """One SAME conv (3 -> 4 channels, 3x3, 8x8, B=2) and one Dense (5 -> 6):
    forward 2 FLOP a multiply-add; the backward the weights' gradient (the
    same count) and, for the Dense fed by the conv, the input's gradient."""
    torch.manual_seed(0)
    conv, dense = common.Conv(3, 4, 3), common.Dense(4 * 8 * 8, 6)
    for p in list(conv.parameters()) + list(dense.parameters()):
        torch.nn.init.normal_(p)
    x = torch.randn(2, 8, 8, 3)
    with FlopCounterMode(display=False) as counter:
        y = dense(common.flatten(conv(x)))
        torch.autograd.grad(y.sum(), list(conv.parameters()) + list(dense.parameters()))
    conv_fwd = 2 * 2 * 8 * 8 * 4 * 3 * 9
    dense_fwd = 2 * 2 * 256 * 6
    assert counter.get_total_flops() == conv_fwd * 2 + dense_fwd * 3


@pytest.mark.parametrize("module", ["lgspair", "lgvae"])
def test_draws_are_per_example(module):
    import importlib
    ref = importlib.import_module(f"reference.{module}")
    cfg = {"image_size": [24, 24, 3], "patch_size": 8, "latent_size": 8, "local_latent_size": 8,
           "bg_latent_size": 8, "global_latent_dims": 8, "local_latent_dims": 8}
    d4 = ref.draws(cfg, (4, 24, 24, 3), torch.Generator().manual_seed(1))
    d2 = ref.draws(cfg, (2, 24, 24, 3), torch.Generator().manual_seed(1))
    assert [t.shape[0] // 2 for t in d4] == [t.shape[0] for t in d2]
