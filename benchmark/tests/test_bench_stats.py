"""The arithmetic of the metrics: the p95 of step intervals, the union of
device intervals and the idle share, the idle gaps' names, and the rooflines'
bytes against the counts of ``chip_smoke.py`` at P1's shapes."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from harness import spec, trace, window
from metrics import conv_ms_per_step, crop_roofline, device_idle_pct, launches_per_step
from metrics import render_roofline, step_mfu_pct


def test_p95_over_intervals():
    step_ms = [10.0] * 95 + [50.0] * 5
    assert window.p95(step_ms) == pytest.approx(10.0 + 0.05 * 40.0)
    assert window.p95(list(range(1, 101))) == pytest.approx(np.percentile(range(1, 101), 95))


def test_union_and_gaps():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 30.0), ("d", 31.0, 32.0)]
    assert trace.union(ops) == [(0.0, 12.0), (20.0, 30.0), (31.0, 32.0)]
    host = [("aten::outer", 0.0, 40.0), ("aten::inner", 11.0, 15.0)]
    gaps = trace.idle_gaps(ops, host)
    assert [n for n, _ in gaps] == ["aten::inner", "aten::outer"]
    assert [s for _, s in gaps] == pytest.approx([8e-6, 1e-6])
    host.append(("aten::innermost", 12.0, 13.0))
    assert trace.idle_gaps(ops, host)[0][0] == "aten::innermost"
    name, seconds = trace.top_ops(ops + [("a", 40.0, 45.0)])[0]
    assert name == "a" and seconds == pytest.approx(15e-6)


def make_trace(ops, steps=2, step_s=0.1, flops=None, cell="c5_lgspair_fp32_b256"):
    return trace.Trace(steps=steps, device_ops=ops, host_ops=[], step_s=step_s,
                       cell=spec.load_cell(cell),
                       families=spec.load_json(os.path.join(spec.HERE, "families.json")),
                       peaks=spec.load_json(os.path.join(spec.HERE, "peaks.json")),
                       flops_per_step=flops)


def test_idle_share_from_synthetic_intervals():
    # Two steps of 100 ms; the device busy 30 ms and 20 ms of them (one overlap).
    ops = [("k", 0.0, 20000.0), ("k", 10000.0, 30000.0), ("k", 100000.0, 120000.0)]
    t = make_trace(ops)
    assert t.busy_s() == pytest.approx(0.05)
    assert device_idle_pct.read(t) == pytest.approx(75.0)
    assert launches_per_step.read(t) == 1.5
    assert device_idle_pct.read(make_trace([])) is None


def test_families_and_conv_time():
    ops = [("void cudnn::winograd_fwd(float)", 0.0, 3000.0), ("sm90_xmma_gemm", 0.0, 1.0),
           ("void render_fwd_kernel<4, false>(...)", 0.0, 5.0),
           ("void at::native::vectorized_elementwise_kernel", 0.0, 7.0)]
    t = make_trace(ops)
    assert [t.family_of(n) for n, _, _ in ops] == ["convolution", "matrix_product", "render",
                                                   "elementwise"]
    assert conv_ms_per_step.read(t) == pytest.approx(1.5)
    assert t.named_us(["render_fwd_kernel"]) == 5.0


def test_mfu():
    t = make_trace([("k", 0.0, 1.0)], step_s=0.1, flops=6.7e11)
    assert step_mfu_pct.read(t) == pytest.approx(10.0)
    assert step_mfu_pct.read(make_trace([("k", 0.0, 1.0)])) is None


def chip_smoke():
    path = os.path.join(spec.ROOT, "chip_smoke.py")
    mod_spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def test_render_bytes_match_chip_smoke_at_p1():
    """With every object pixel read by some tap, chip_smoke's sector count is
    all of objs, and its byte counts are the reader's."""
    b, grid, h, hh, c = 256, 4, 32, 48, 3
    k = grid * grid
    # Boxes that stretch each object over the whole canvas: every object row
    # and column is tapped.
    ys = torch.linspace(0.0, h - 1.0, hh).expand(b, k, hh).clone()
    ys[..., -1] = h - 1.5
    xs = ys.clone()
    cs = chip_smoke()
    out, objs_read = cs.bounds((b, grid, h, hh, c), ys, xs, noise_scale=0.0)
    assert objs_read == 4 * b * k * h * h * (c + 1)
    ours = render_roofline.work(b, k, h, hh, c)
    assert [n for n, _ in ours] == [out["fwd"][2], out["bwd"][2]]
    t = make_trace([("void render_fwd_kernel<4, false>", 0.0, 1000.0)], steps=1)
    assert render_roofline.shapes(t) == (b, k, h, hh, c)


def test_crop_bytes_match_chip_smoke_at_p1():
    cs = chip_smoke()
    b, grid, hh, s, c = 256, 4, 48, 32, 3
    ref = cs.crop_bounds((b, grid, hh, s, c))
    ours = crop_roofline.work(b, grid * grid, hh, s, c)
    assert [n for n, _ in ours] == [ref["fwd"][2], ref["bwd"][2]]
    assert [f for _, f in ours] == [ref["fwd"][3], ref["bwd"][3]]
    t = make_trace([("void crop_fwd_kernel<8>", 0.0, 35.0)], steps=1)
    assert crop_roofline.shapes(t) == (b, grid * grid, hh, s, c)
    peaks = t.peaks
    least = sum(max(n / peaks["bytes_per_s"], f / peaks["flops"]["float32"]) for n, f in ours)
    assert crop_roofline.read(t) == pytest.approx(100.0 * least / 35e-6)
    assert render_roofline.read(t) is None
