"""The port's per-tensor clip against the JAX package's on large tensors.

``clip_by_per_tensor_norm`` of both packages on the same float32 gradient,
one tensor at a time, at sizes of the SPAIR models' leaves: the dense
background decoder's last kernel at a 24-px canvas (1024 x 1728) and at
config #5's 48 px (1024 x 6912), and a small one. Each gradient's norm is
2, so the clip scales it. Held: the clipped tensors within 1e-6 of the JAX
tensor's L2 norm; torch's CPU norm kernel (``torch.linalg.vector_norm``,
``torch._foreach_norm``) misses by 2.3e-5 and 1.8e-4 at the two large sizes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from split_vae_torch.train.optim import clip_by_per_tensor_norm as torch_clip  # noqa: E402
from split_vae_tpu.train.optim import clip_by_per_tensor_norm as jax_clip  # noqa: E402


@pytest.mark.parametrize("shape", [(1000, 64), (1728, 1024), (6912, 1024)])
def test_clip_matches_the_jax_clip(shape):
    g = np.random.RandomState(0).randn(*shape).astype(np.float32)
    g *= np.float32(2.0 / np.sqrt(np.sum(g.astype(np.float64) ** 2)))
    want, _ = jax_clip(1.0).update([jnp.asarray(g)], None)
    got, _ = torch_clip(1.0).update([torch.from_numpy(g)], ())
    want, got = np.asarray(want[0], np.float64), got[0].double().numpy()
    gap = np.linalg.norm(got - want) / np.linalg.norm(want)
    kernel = float(torch.linalg.vector_norm(torch.from_numpy(g))) / 2.0 - 1.0
    print(f"\n{shape}: clip within {gap:.3g} of JAX's; torch's norm kernel off by {kernel:.3g}")
    assert gap <= 1e-6, gap
