"""The VAE family's train step on one card as one CUDA graph.

Eagerly, a VAE-family train step (``train/steps.py::make_vae_train_step``)
launches 700-800 kernels from Python and autograd, and on an H100 the host
takes about as long to launch them as the card takes to run them; the step
then waits on the host, and its time follows the host's speed. Captured
once as a CUDA graph, the step is one launch and its time is the card's.

``GraphedStep`` wraps the step's body, ``body(state, batch, noise) ->
metrics``, which updates the state in place:

- each batch shape is first run eagerly, and that run records the step's
  draws from ``core/noise.py::Noise`` (the shape of each and the call that
  makes it);
- the next call of that shape captures the body over a static copy of the
  batch and one static buffer a draw, then replays the graph. Every later
  call copies its batch in, makes the same draws from the state's generator
  in the same order (or copies in the replayed ones), so the values are
  those the eager step would draw, and replays;
- the graph reads and writes the parameters and the optimizer's state in
  place (the fused optimizer of ``kernels/adam.py`` does): a call whose
  state holds other tensors (a state restored or replaced) records again,
  and a body that would put new tensors in the state is run eagerly;
- the step's metrics are copied out of the graph's outputs, which the next
  replay overwrites; the port's counters (``core/tracing.py::count``) that
  the captured body counted are counted again at every replay, since its
  kernels launch again; ``state.step`` advances by one a call.

The step runs eagerly on the CPU, with the port's tracing on (the spans
need each step's Python), under autograd's anomaly mode (``--debug_nans``,
which reads every gradient on the host), where a draw has no static form (a
permutation, a render seed) and where the capture fails (a body that waits
for the card).
Data and tensor parallelism keep the eager step (``steps.py`` decides).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from split_vae_torch.core import tracing
from split_vae_torch.core.noise import Noise
from split_vae_torch.core.state import TrainState, tree_tensors

Body = Callable[[TrainState, torch.Tensor, Noise], Dict[str, torch.Tensor]]


class _Recorder(Noise):
    """A Noise that records each draw as it hands it out: the global shape,
    the dtype a replay of it takes and the call that makes it."""

    def __init__(self, generator, replay=None):
        super().__init__(generator, replay)
        self.draws: List[Tuple[tuple, torch.dtype, Callable]] = []
        self.static = True

    def _draw(self, shape, per_example, dtype, make):
        self.draws.append((tuple(shape), dtype or self.dtype, make))
        return super()._draw(shape, per_example, dtype, make)

    def permutation(self, n):
        self.static = False
        return super().permutation(n)

    def seed(self):
        self.static = False
        return super().seed()


def cuda_capture(fn: Callable[[], Dict[str, torch.Tensor]]):
    """``fn()`` captured as a CUDA graph: (the graph's replay, what fn returned)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph.replay, out


def fingerprint(state: TrainState) -> tuple:
    """What a graph holds of the state: its model, its generator and the
    addresses of its parameters and of the optimizer's tensors."""
    return (id(state.model), id(state.generator),
            tuple(p.data_ptr() for p in state.params),
            tuple(t.data_ptr() for t in tree_tensors(state.opt_state)))


@dataclass
class _Shape:
    """One batch shape's recording and, once captured, its graph."""

    state: tuple                      # ``fingerprint`` of the state it was recorded on
    device: torch.device
    draws: List[Tuple[tuple, torch.dtype, Callable]]
    eager: bool                       # no graph for this shape: run it eagerly
    buffers: List[torch.Tensor] = field(default_factory=list)
    batch: Optional[torch.Tensor] = None
    replay: Optional[Callable[[], None]] = None
    out: Dict[str, torch.Tensor] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)


class GraphedStep:
    """``train_step(state, batch, replay=None) -> (state, metrics)`` over
    ``body`` (the module's docstring). ``capture`` stands in for
    ``cuda_capture`` in the tests, on any device; without it only CUDA
    batches are captured."""

    def __init__(self, body: Body, capture: Optional[Callable] = None):
        self.body = body
        self.capture = capture or cuda_capture
        self.any_device = capture is not None
        self.shapes: Dict[tuple, _Shape] = {}

    def eager(self, state: TrainState, batch: torch.Tensor,
              replay: Optional[Sequence[torch.Tensor]] = None):
        with tracing.span("step"):
            return state, self.body(state, batch, Noise(state.generator, replay))

    def __call__(self, state: TrainState, batch: torch.Tensor,
                 replay: Optional[Sequence[torch.Tensor]] = None):
        if (tracing.enabled() or torch.is_anomaly_enabled()
                or not (self.any_device or batch.is_cuda)):
            return self.eager(state, batch, replay)
        key = (tuple(batch.shape), batch.dtype, batch.device)
        shape = self.shapes.get(key)
        if shape is not None and shape.eager:
            return self.eager(state, batch, replay)
        if shape is None or shape.state != fingerprint(state):
            return self._record(key, state, batch, replay)
        drawn = self._draw(shape, replay)
        if drawn is None:  # replayed draws that are not the recorded ones
            return self.eager(state, batch, replay)
        if shape.replay is None and not self._capture(shape, state, batch, drawn):
            return self.eager(state, batch, drawn)
        shape.batch.copy_(batch)
        shape.replay()
        state.step += 1
        for name, n in shape.counts.items():
            tracing.count(name, n)
        return state, {k: v.clone() for k, v in shape.out.items()}

    def _record(self, key, state, batch, replay):
        """The eager step, recording its draws for the graph of this shape."""
        noise = _Recorder(state.generator, replay)
        with tracing.span("step"):
            metrics = self.body(state, batch, noise)
        self.shapes[key] = _Shape(fingerprint(state), batch.device, noise.draws,
                                  eager=not noise.static)
        return state, metrics

    def _draw(self, shape: _Shape, replay) -> Optional[List[torch.Tensor]]:
        """This step's draws in the shape's buffers: the replayed ones, or
        the recorded calls made again on the state's generator."""
        if not shape.buffers:
            shape.buffers = [torch.empty(s, dtype=d, device=shape.device)
                             for s, d, _ in shape.draws]
        if replay is not None:
            replay = list(replay)
            if len(replay) != len(shape.buffers):
                return None
            for buf, r in zip(shape.buffers, replay):
                r = torch.as_tensor(r)
                if tuple(r.shape) != tuple(buf.shape):
                    return None
                buf.copy_(r)
        else:
            for buf, (s, _, make) in zip(shape.buffers, shape.draws):
                buf.copy_(make(s))
        return shape.buffers

    def _capture(self, shape: _Shape, state: TrainState, batch: torch.Tensor,
                 drawn: List[torch.Tensor]) -> bool:
        """Captures the body over static copies; False (and the shape left to
        the eager step) where the capture fails or the body would put new
        tensors in the state. The state is as it was either way."""
        step, opt_state, counted = state.step, state.opt_state, tracing.counters()
        shape.batch = batch.clone()
        try:
            shape.replay, shape.out = self.capture(
                lambda: self.body(state, shape.batch, Noise(state.generator, list(drawn))))
            kept = fingerprint(state) == shape.state
        except Exception:  # a body the capture cannot take: it waits for the card
            kept = False
        after = tracing.counters()
        state.step, state.opt_state = step, opt_state
        if not kept:
            shape.eager, shape.replay, shape.out, shape.batch = True, None, {}, None
            return False
        shape.counts = {k: v - counted.get(k, 0) for k, v in after.items()
                        if v != counted.get(k, 0)}
        # The capture counted what the first replay counts again.
        for name, n in shape.counts.items():
            tracing.count(name, -n)
        return True

