"""The optimizer's list form against its per-tensor form, bit for bit.

``train/optim.py`` runs the clip, Adam, AMSGrad and the non-finite skip as
``torch._foreach_*`` calls over the parameter list (a host call an
operation, where a loop made one an operation and tensor).
``per_tensor`` below is the same math written one tensor at a time, the form
the JAX package's optax chain is held to in the step tests. Each chain takes
the same gradients (a step with a NaN and one with an Inf among them, which
the skip must drop) and must give equal updates and state, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from split_vae_torch.train import optim  # noqa: E402
from split_vae_torch.train.schedules import gm_lr_schedule  # noqa: E402


def per_tensor(kind, lr=1e-3, b1=0.9, b2=0.999, eps=1e-7, max_norm=1.0):
    """The chain of ``kind`` as update(grads, state) over single tensors."""
    def clip(grads):
        if grads[0].is_cuda:
            norms = torch._foreach_norm(grads)
        else:
            norms = [torch.sqrt(torch.sum(g * g)) for g in grads]
        return [g * (max_norm / torch.clamp_min(n, max_norm)) for g, n in zip(grads, norms)]

    def adam(grads, state, amsgrad=False):
        rate = gm_lr_schedule(lr)(state.count) if kind == "gm" else lr
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        t = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
        if amsgrad:
            nu_max = [torch.maximum(vm, v / bc2) for vm, v in zip(state.nu_max, nu)]
            ups = [-rate * ((m / bc1) / (torch.sqrt(vm) + eps)) for m, vm in zip(mu, nu_max)]
            return ups, optim.AmsgradState(count, mu, nu, nu_max)
        ups = [-rate * ((m / bc1) / (torch.sqrt(v / bc2) + eps)) for m, v in zip(mu, nu)]
        return ups, optim.AdamState(count, mu, nu)

    def update(grads, state):
        if kind == "classifier":
            return adam(grads, state, amsgrad=True)
        inner_state = state.inner_state
        if kind == "spair":
            ups, adam_state = adam(clip(grads), inner_state[1])
            inner = ((), adam_state)
        else:
            ups, inner = adam(grads, inner_state)
        finite = torch.stack([torch.isfinite(u).all() for u in list(grads) + ups]).all()
        out = [torch.where(finite, u, torch.zeros_like(u)) for u in ups]
        kept = optim._select(finite, inner, state.inner_state)
        return out, optim.SkipNonFiniteState(
            state.total_notfinite + (~finite).to(torch.int32), kept)

    return update


CHAINS = {"spair": lambda: optim.spair_optimizer(1e-3), "vae": lambda: optim.vae_optimizer(1e-3),
          "gm": lambda: optim.gm_optimizer(1e-3), "classifier": optim.classifier_optimizer}


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in _flat(sub)] if isinstance(tree, (list, tuple)) else []


def _structure(tree):
    """The containers of a state (the checkpoint and the shard maps read
    Adam's moments as lists)."""
    if isinstance(tree, (list, tuple)):
        return type(tree), [_structure(x) for x in tree]
    return type(tree)


@pytest.mark.parametrize("kind", list(CHAINS))
def test_list_form_equals_the_per_tensor_form(kind):
    rng = np.random.RandomState(3)
    shapes = [(64, 32), (32,), (3, 3, 8, 16), (1,), (2000,)]
    params = [torch.zeros(s) for s in shapes]
    tx = CHAINS[kind]()
    lr = 1e-4 if kind == "classifier" else 1e-3
    ref = per_tensor(kind, lr=lr)
    state = want_state = tx.init(params)
    for step in range(6):
        # large gradients on some steps, so the clip scales them; a NaN at
        # step 2 and an Inf at step 4, which the skip drops (the classifier's
        # chain has no skip, so it sees finite gradients only)
        scale = 10.0 ** rng.uniform(-3, 2)
        grads = [torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)) for s in shapes]
        if kind != "classifier" and step in (2, 4):
            grads[step // 2].view(-1)[1] = float("nan") if step == 2 else float("inf")
        got, state = tx.update([g.clone() for g in grads], state)
        want, want_state = ref([g.clone() for g in grads], want_state)
        for a, b in zip(list(got) + _flat(state), list(want) + _flat(want_state)):
            assert a.dtype == b.dtype and torch.equal(a, b), (kind, step)
        assert _structure(state) == _structure(want_state)
    if kind != "classifier":
        assert int(state.total_notfinite) == 2
