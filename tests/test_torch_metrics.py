"""The port's streaming metrics (split_vae_torch.core.metrics) against the JAX
package's (split_vae_tpu.core.metrics) on seeded inputs, rtol 1e-6, and the
rule that ``MeanMetrics.update`` never waits for the device: it calls no
``.item()``, ``.cpu()`` or ``float()``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from split_vae_torch.core import metrics as port  # noqa: E402
from split_vae_tpu.core import metrics as ref  # noqa: E402


def _steps(seed, n=50):
    rng = np.random.RandomState(seed)
    steps = []
    for i in range(n):
        m = {"total_loss": np.float32(rng.uniform(1e3, 1e4)),
             "kl": np.float32(rng.randn() * 1e-3),
             "notfinite_updates": np.float32(rng.randint(0, 3))}
        if i % 3 == 0:
            m["sometimes"] = np.float32(rng.uniform())
        steps.append(m)
    return steps


@pytest.mark.parametrize("seed", [0, 1])
def test_mean_metrics_equal_jax(seed):
    mine, theirs = port.MeanMetrics(), ref.MeanMetrics()
    for m in _steps(seed):
        mine.update({k: torch.tensor(v) for k, v in m.items()})
        theirs.update(m)
    mine.update({"host": 2.5})
    theirs.update({"host": 2.5})
    got, want = mine.result(), theirs.result()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    # Draining twice, then after a reset, as the loop does at each interval.
    assert mine.result() == got
    mine.reset()
    theirs.reset()
    assert mine.result() == theirs.result() == {}


def test_mean_metrics_update_does_not_sync(monkeypatch):
    steps = [{k: torch.tensor(v) for k, v in m.items()} for m in _steps(2)]

    def refuse(*args, **kwargs):
        raise AssertionError("update waited for the device")

    mine = port.MeanMetrics()
    with monkeypatch.context() as mp:
        for name in ("item", "cpu", "__float__", "tolist", "numpy"):
            mp.setattr(torch.Tensor, name, refuse)
        for m in steps:
            mine.update(m)
    want = ref.MeanMetrics()
    for m in _steps(2):
        want.update(m)
    got = mine.result()
    for k, v in want.result().items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("one_hot", [True, False])
def test_accuracy_equals_jax(one_hot):
    rng = np.random.RandomState(3)
    mine, theirs = port.AccuracyMetric(), ref.AccuracyMetric()
    for _ in range(4):
        y = rng.randint(0, 10, 32)
        labels = np.eye(10, dtype=np.float32)[y] if one_hot else y
        logits = rng.randn(32, 10).astype(np.float32)
        logits[: 12, :] = np.eye(10, dtype=np.float32)[y[:12]] * 9  # some right answers
        mine.update(torch.from_numpy(labels), torch.from_numpy(logits))
        theirs.update(labels, logits)
    assert mine.result() == pytest.approx(theirs.result(), rel=1e-6)
    assert 0 < mine.result() < 1
    mine.reset()
    assert mine.result() == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_linear_assignment_equals_jax(seed):
    rng = np.random.RandomState(seed)
    labels = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 200)]
    pred = rng.randn(200, 30).astype(np.float32)
    got = port.linear_assignment(labels, pred)
    want = ref.linear_assignment(labels, pred)
    assert got.dtype == want.dtype and np.array_equal(got, want)
