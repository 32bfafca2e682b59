"""Streaming metrics (split_vae_tpu/core/metrics.py): running means over the
steps' device scalars, an accuracy and the cluster-to-class relabeling.

The reference's tf.keras.metrics.Mean / Accuracy pools (vae/trainer.py:99-118,
spair/trainer.py:123-132). ``MeanMetrics.update`` keeps the step's 0-d
tensors where they are and never waits for the device; ``result`` drains them
with one stack a key and one device-to-host copy, so an interval of a
thousand steps costs one sync. Under data parallelism (``mesh``) ``result``
also takes the ranks' mean of the means, one all-reduce an interval: every
rank's steps hold equal shares of the global batch, so rank 0's ``train/``
records are the global batch's, as in the JAX package. The mean runs over
the data group (``parallel/mesh.py::all_reduce_mean_values``): the ranks of
a model group hold equal values already.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from split_vae_torch.core import tracing
from split_vae_torch.parallel.mesh import Mesh, all_reduce_mean_values


class MeanMetrics:
    """Running mean per key; takes 0-d tensors (on any one device) or host numbers.
    With a ``mesh`` whose data group holds more than one rank, ``result`` is
    a collective of that group: every rank calls it at the same point, with
    the same keys."""

    def __init__(self, mesh: Mesh = Mesh()):
        self.mesh = mesh
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._pending: List[Dict] = []

    def update(self, metrics: Dict) -> None:
        with tracing.span("metrics.update"):
            self._pending.append(metrics)

    def _add(self, key: str, value: float) -> None:
        self._sums[key] = self._sums.get(key, 0.0) + value
        self._counts[key] = self._counts.get(key, 0) + 1

    def _drain(self) -> None:
        if not self._pending:
            return
        with tracing.span("metrics.drain"):
            self._drain_pending()

    def _drain_pending(self) -> None:
        stacked: Dict[str, List[torch.Tensor]] = {}
        for metrics in self._pending:
            for k, v in metrics.items():
                if isinstance(v, torch.Tensor):
                    stacked.setdefault(k, []).append(v.detach().reshape(()))
                else:
                    self._add(k, float(np.asarray(v)))
        self._pending = []
        if not stacked:
            return
        keys = list(stacked)
        # fp32 -> fp64 is exact; the sums then run in fp64 on the host, as in
        # the JAX package.
        flat = torch.cat([torch.stack(stacked[k]).to(torch.float64) for k in keys])
        host = flat.cpu().numpy()
        start = 0
        for k in keys:
            for v in host[start:start + len(stacked[k])]:
                self._add(k, float(v))
            start += len(stacked[k])

    def result(self) -> Dict[str, float]:
        self._drain()
        keys = list(self._sums)
        means = [self._sums[k] / max(self._counts[k], 1) for k in keys]
        return dict(zip(keys, all_reduce_mean_values(means, self.mesh)))

    def reset(self) -> None:
        self._pending = []
        self._sums.clear()
        self._counts.clear()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class AccuracyMetric:
    """Categorical accuracy over (one-hot or int labels, logits/probs)."""

    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, labels, preds) -> None:
        labels, preds = _host(labels), _host(preds)
        if labels.ndim > 1:
            labels = labels.argmax(axis=-1)
        if preds.ndim > 1:
            preds = preds.argmax(axis=-1)
        self.correct += int((labels == preds).sum())
        self.total += int(labels.shape[0])

    def result(self) -> float:
        return self.correct / self.total if self.total else 0.0

    def reset(self) -> None:
        self.correct = 0
        self.total = 0


def linear_assignment(labels: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Majority-vote cluster -> class relabeling (vae/trainer.py:40-67).

    labels: one-hot [N, num_class]; pred: logits/probs [N, num_cluster].
    Returns one-hot predicted classes [N, num_class].
    """
    labels = np.asarray(labels)
    pred = np.asarray(pred)
    num_class = labels.shape[1]
    num_cluster = pred.shape[1]
    lab = labels.argmax(axis=1)
    cluster = pred.argmax(axis=1)
    cluster_pred = np.zeros_like(lab)
    for i in range(num_cluster):
        members = lab[cluster == i]
        if members.size:
            vals, counts = np.unique(members, return_counts=True)
            cluster_pred[cluster == i] = vals[counts.argmax()]
    return np.eye(num_class, dtype=np.float32)[cluster_pred]
