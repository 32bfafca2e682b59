"""The port's exact resize2x -> conv fusion (split_vae_torch/nn/pixel_shuffle.py)
against the JAX package's (split_vae_tpu/nn/pixel_shuffle.py) on the CPU.

The same seeded numpy inputs go through both packages (weights HWIO there,
OIHW here), the JAX side at ``jax.default_matmul_precision("highest")`` as
tests/test_pixel_shuffle.py runs it:

- ``resize2x_conv`` (3x3, phase form) at the JAX test's (s, cin, cout)
  cases, an odd s among them; ``resize2x_conv_any`` (dilated form) at k = 3,
  4, 6; both mixed forms. Each against its JAX counterpart, against the
  port's ``resize2x_conv_chain``, and that chain against the JAX test's
  ``_reference_chain``: forward atol/rtol 1e-5; the gradients of x, the
  kernel and the bias atol 2e-4, rtol 1e-4 (the JAX test's limits). The mixed
  forward is bit-equal to the fused one.
- h != w (the JAX forms read one side for both axes): the port's forms
  against its chain only.
- In bfloat16 the phase and folded kernels are bit-equal to the JAX ones
  (both formed by einsums in bfloat16).
- flax-initialized ``Resize2xConv`` and ``Resize2xConvAny`` layers, converted
  by ``interop/flax_params.py``, equal to the port's layers: float32 at
  1e-5, bfloat16 at BF16_TOL of the output's largest magnitude, two bfloat16
  ulps (measured: 3.4e-3 for the 3x3 phase form, 3.2e-3 for the 6x6 dilated
  form, 7.0e-3 for the fallback to the chain where the output is not
  exactly 2x, which is tested too).
- Every top-level definition of the JAX module has its counterpart here.
- No ``F.interpolate`` at an exact-2x site: ``ObjDecoder``, ``ImageDecoder``,
  ``BackgroundModel``, ``GlimpseDecoder`` and ``ConvDecoder.Conv_3``, forward
  and backward, with ``F.interpolate`` patched to raise.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import split_vae_tpu.nn.pixel_shuffle as jps  # noqa: E402
from split_vae_torch.interop.flax_params import load_flax_params  # noqa: E402
from split_vae_torch.nn import pixel_shuffle as pps  # noqa: E402
from split_vae_tpu.nn.common import set_activation_dtype  # noqa: E402
from tests.test_pixel_shuffle import _reference_chain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=1e-4)
BF16_TOL = 2 ** -7  # of the output's largest magnitude: two bfloat16 ulps of it

# (form, k, s, cin, cout): the JAX tests' cases (tests/test_pixel_shuffle.py).
CASES = ([("resize2x_conv", 3, s, cin, cout)
          for s, cin, cout in ((8, 32, 64), (16, 64, 32), (4, 3, 4), (5, 2, 3))]
         + [("resize2x_conv_any", k, s, cin, cout)
            for k, s, cin, cout in ((3, 8, 4, 8), (4, 8, 8, 16), (4, 5, 3, 4), (6, 8, 8, 6),
                                    (6, 4, 2, 3))]
         + [("resize2x_conv_mixed", 3, 5, 3, 4)]
         + [("resize2x_conv_any_mixed", k, 6, 4, 8) for k in (3, 4, 6)])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these small CPU convs run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, hw, k, cin, cout, batch=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, *hw, cin).astype(np.float32)
    kernel = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    cot = rng.randn(batch, 2 * hw[0], 2 * hw[1], cout).astype(np.float32)
    return x, kernel, bias, cot


def _oihw(kernel):
    return torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())


def _jax_grads(fn, x, kernel, bias, cot):
    """fn's output and its gradients against cot, jitted (one compile, not an
    eager dispatch an op)."""
    def run(x, kernel, bias, cot):
        out, vjp = jax.vjp(fn, x, kernel, bias)
        return out, vjp(cot)

    with jax.default_matmul_precision("highest"):
        out, (gx, gk, gb) = jax.jit(run)(*(jnp.asarray(a) for a in (x, kernel, bias, cot)))
    return np.asarray(out), (np.asarray(gx), np.asarray(gk).transpose(3, 2, 0, 1), np.asarray(gb))


def _port_grads(fn, x, kernel, bias, cot):
    ins = [torch.from_numpy(x).requires_grad_(), _oihw(kernel).requires_grad_(),
           torch.from_numpy(bias).requires_grad_()]
    out = fn(*ins)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), ins)
    return out.detach().numpy(), tuple(g.numpy() for g in grads)


def _close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{what}, gradient {i}")


@pytest.mark.parametrize("form, k, s, cin, cout", CASES,
                         ids=[f"{f}-k{k}-s{s}-{ci}to{co}" for f, k, s, ci, co in CASES])
def test_form_matches_jax_and_the_chain(form, k, s, cin, cout):
    x, kernel, bias, cot = _inputs(1000 * k + 10 * s + cin, (s, s), k, cin, cout)
    want, want_g = _jax_grads(getattr(jps, form), x, kernel, bias, cot)
    chain_jax, chain_jax_g = _jax_grads(_reference_chain, x, kernel, bias, cot)
    got, got_g = _port_grads(getattr(pps, form), x, kernel, bias, cot)
    chain, chain_g = _port_grads(pps.resize2x_conv_chain, x, kernel, bias, cot)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_allclose(got, chain, **FWD_TOL)
    np.testing.assert_allclose(chain, chain_jax, **FWD_TOL)
    _close(got_g, want_g, GRAD_TOL, f"{form} vs JAX")
    _close(got_g, chain_g, GRAD_TOL, f"{form} vs the chain")
    _close(chain_g, chain_jax_g, GRAD_TOL, "chain vs the JAX chain")
    if form.endswith("_mixed"):  # the fused forward, bit for bit
        fused = getattr(pps, form[:-len("_mixed")])
        np.testing.assert_array_equal(
            got, fused(torch.from_numpy(x), _oihw(kernel), torch.from_numpy(bias)).numpy())


@pytest.mark.parametrize("form, k", [("resize2x_conv", 3), ("resize2x_conv_mixed", 3),
                                     ("resize2x_conv_any", 3), ("resize2x_conv_any", 6),
                                     ("resize2x_conv_any_mixed", 4)])
@pytest.mark.parametrize("hw", [(5, 8), (8, 3)])
def test_non_square_matches_the_chain(form, k, hw):
    x, kernel, bias, cot = _inputs(7 * k + hw[0], hw, k, 3, 4, batch=2)
    got, got_g = _port_grads(getattr(pps, form), x, kernel, bias, cot)
    want, want_g = _port_grads(pps.resize2x_conv_chain, x, kernel, bias, cot)
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 4)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    _close(got_g, want_g, GRAD_TOL, f"{form} at {hw}")


def test_no_bias_and_bf16_kernels_bit_equal_to_jax():
    x, kernel, _, _ = _inputs(3, (5, 5), 3, 3, 4, batch=2)
    np.testing.assert_array_equal(
        pps.resize2x_conv(torch.from_numpy(x), _oihw(kernel)).numpy(),
        pps.resize2x_conv_mixed(torch.from_numpy(x), _oihw(kernel)).numpy())
    rng = np.random.RandomState(5)
    for k in (3, 6):
        kern = jnp.asarray((rng.randn(k, k, 16, 8) * 0.3).astype(np.float32), jnp.bfloat16)
        w = _oihw(np.asarray(kern, np.float32)).to(torch.bfloat16)
        if k == 3:  # JAX's blocks (py, px, cout) on the last dim, the port's (cout, py, px) first
            want = np.asarray(jps._phase_kernels(kern), np.float32)
            got = pps._phase_kernels(w).float().reshape(8, 2, 2, 16, 3, 3)
            got = got.permute(4, 5, 3, 1, 2, 0).reshape(3, 3, 16, 32).numpy()
        else:  # the folded kernel, flipped and [Cin, Cout] first for the transposed conv
            s = jnp.asarray(jps._stencil_matrix(k), jnp.bfloat16)
            want = np.asarray(jnp.einsum("yxio,yd,xe->deio", kern, s, s), np.float32)
            fs = torch.as_tensor(pps._flipped_stencil(k), dtype=torch.bfloat16)
            got = torch.einsum("oiyx,yd,xe->iode", w, fs, fs).float().flip(2, 3)
            got = got.permute(2, 3, 0, 1).numpy()
        np.testing.assert_array_equal(got, want)


def _flax_layer(layer, dtype_name):
    """The JAX layer's output and its parameters as numpy, under the compute
    dtype ``dtype_name`` (restored to float32)."""
    set_activation_dtype(dtype_name)
    try:
        x = np.random.RandomState(11).randn(2, 6, 6, 5).astype(np.float32)
        variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
        variables = jax.tree.map(lambda v: v + 0.1, variables)  # biases off zero
        with jax.default_matmul_precision("highest"):
            want = layer.apply(variables, jnp.asarray(x))
    finally:
        set_activation_dtype("float32")
    return x, jax.tree.map(np.asarray, variables["params"]), want


@pytest.mark.parametrize("kind, out_hw", [("3x3", (12, 12)), ("6x6", (12, 12)),
                                          ("3x3", (13, 11)), ("6x6", (10, 12))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_matches_flax(kind, out_hw, dtype):
    if kind == "3x3":
        layer, port = jps.Resize2xConv(7, out_hw), pps.Resize2xConv(5, 7, out_hw)
    else:
        layer, port = (jps.Resize2xConvAny(7, (6, 6), out_hw),
                       pps.Resize2xConvAny(5, 7, (6, 6), out_hw))
    port.dtype = None if dtype == "float32" else torch.bfloat16
    x, params, want = _flax_layer(layer, dtype)
    load_flax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert str(got.dtype) == f"torch.{want.dtype}" and got.shape == want.shape
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FWD_TOL)
    else:
        gap = np.abs(got - want).max() / np.abs(want).max()
        assert gap <= BF16_TOL, gap


def test_every_jax_definition_has_a_counterpart():
    with open(os.path.join(REPO, "split_vae_tpu", "nn", "pixel_shuffle.py")) as f:
        tree = ast.parse(f.read())
    names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets]
    missing = [n for n in names if n != "Array" and not hasattr(pps, n)]  # Array: a JAX alias
    assert len(names) >= 18 and not missing, missing


def _decoder_sites():
    from split_vae_torch.nn.decoders import ConvDecoder
    from split_vae_torch.nn.spair_nets import (BackgroundModel, GlimpseDecoder, ImageDecoder,
                                               ObjDecoder)

    gen = torch.Generator().manual_seed(0)
    conv3 = ConvDecoder(8, (16, 12)).Conv_3
    return {
        "ObjDecoder": (ObjDecoder(16, 3, 8, 8), torch.randn(4, 8, generator=gen)),
        "ImageDecoder": (ImageDecoder(8, (24, 16)), torch.randn(2, 8, generator=gen)),
        "BackgroundModel": (BackgroundModel((24, 24), 4),
                            torch.rand(2, 24, 24, 3, generator=gen)),
        "GlimpseDecoder": (GlimpseDecoder(12, 3, 8), torch.randn(4, 8, generator=gen)),
        "ConvDecoder.Conv_3": (conv3, torch.randn(2, 8, 6, 32, generator=gen)),
    }


@pytest.mark.parametrize("site", ["ObjDecoder", "ImageDecoder", "BackgroundModel",
                                  "GlimpseDecoder", "ConvDecoder.Conv_3"])
def test_no_upsampled_tensor_at_an_exact_2x_site(site, monkeypatch):
    from split_vae_torch.core.noise import Noise
    from split_vae_torch.nn.common import init_params

    module, x = _decoder_sites()[site]
    init_params(module, torch.Generator().manual_seed(1))

    def interpolate(*args, **kwargs):
        raise AssertionError("F.interpolate at an exact-2x site")

    monkeypatch.setattr(F, "interpolate", interpolate)
    if site == "BackgroundModel":
        out = module(x, Noise(torch.Generator().manual_seed(2)))[0]
    else:
        out = module(x)
    out = out if isinstance(out, torch.Tensor) else torch.cat(out, -1)
    grads = torch.autograd.grad(out.square().sum(), [p for p in module.parameters()])
    assert all(torch.isfinite(g).all() for g in grads)
    fallback = pps.Resize2xConv(3, 2, (9, 9))  # the guard is live: not 2x, the chain
    with pytest.raises(AssertionError, match="exact-2x"):
        fallback(torch.zeros(1, 4, 4, 3))
