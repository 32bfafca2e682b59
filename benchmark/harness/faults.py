"""Faults planted in the program's step on purpose, to see the output check
fail: each wraps ``train_step(state, batch, replay=None)``."""

from __future__ import annotations

import copy

import torch


def unchanged(step):
    """A step that returns its state as it found it (its metrics computed)."""
    def broken(state, batch, replay=None):
        params = [p.detach().clone() for p in state.params]
        opt_state, count = copy.deepcopy(state.opt_state), state.step
        state, metrics = step(state, batch, replay=replay)
        with torch.no_grad():
            for p, saved in zip(state.params, params):
                p.copy_(saved)
        state.opt_state, state.step = opt_state, count
        return state, metrics
    return broken


def half_batch(step):
    """A step on the first half of the batch alone, its means over that half
    (every draw is per example and batch-major: its first half is that
    half's)."""
    def broken(state, batch, replay=None):
        return step(state, batch[:batch.shape[0] // 2],
                    replay=None if replay is None else [t[:t.shape[0] // 2] for t in replay])
    return broken


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
