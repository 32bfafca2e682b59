"""A train step on one card as one CUDA graph.

Eagerly, a train step (``train/steps.py``) launches hundreds to thousands of
kernels from Python and autograd, and on an H100 the host can take longer to
launch them than the card takes to run them; the step then waits on the host,
and its time follows the host's speed. Captured once as a CUDA graph, the
step is one launch and its time is the card's.

``GraphedStep`` wraps the step's body, ``body(state, batch, noise) ->
metrics``, which updates the state in place:

- each batch shape is first run eagerly, and that run records the step's
  draws from ``core/noise.py::Noise`` (the shape of each and the call that
  makes it), which of them are render seeds (``Noise.seed``), and whether
  the body reads the step's count (``Noise.step``);
- the next call of that shape captures the body over a static copy of the
  batch, one static buffer a draw and, where the body reads it, a static
  step. Every later call copies its batch in, makes the same draws from the
  state's generator in the same order (or copies in the replayed ones),
  fills the step buffer with ``state.step`` (one fill kernel), and replays.
  So the values are those the eager step would use, and the generator
  advances as the eager step's does. A render seed is drawn from the
  generator under replayed draws too, as ``Noise.seed`` is, and is no entry
  of the replayed list;
- the graph reads and writes the parameters and the optimizer's state in
  place (the fused optimizer of ``kernels/adam.py`` does): a call whose
  state holds other tensors (a state restored or replaced) records again,
  and a body that would put new tensors in the state is run eagerly;
- the step's metrics are copied out of the graph's outputs, which the next
  replay overwrites; the port's counters (``core/tracing.py::count``) that
  the captured body counted are counted again at every replay, since its
  kernels launch again; ``state.step`` advances by one a call.

This module alone decides between the graph and the eager step. The step
runs eagerly on a mesh of more than one process (data and tensor
parallelism: its draws take the mesh's data rank and size), on the CPU, with
the port's tracing on (the spans need each step's Python), under autograd's
anomaly mode (``--debug_nans``, which reads every gradient on the host),
where a draw has no static form (``Noise.permutation``; the glimpse
scramble's ``Noise.batch_permutation`` is a uniform draw, argsorted on the
device, and so is replayed like any other) and where the capture fails
(a body that waits for the card; a warning names the error, once a batch
shape). The counters ``step.graphed`` (a replay) and ``step.eager`` (a call
that ran the body's Python eagerly: a recording, a fallback, several
processes, tracing, anomaly mode, the CPU) say which path each call took.

Every call that runs the body's Python runs it under cuDNN's autotuner
(``autotuned``): the first time cuDNN meets a convolution's shape there, it
times its engines and keeps the fastest in PyTorch's process-wide plan cache
(keyed by the shapes, layout, dtype, determinism and TF32, not by the
autotuner's flag). The recording of a batch shape meets every convolution
its graph runs, so the capture, which runs under the caller's settings,
and every replay take the tuned plans and time nothing. TF32 stays off and
``deterministic`` as the caller set it (tuning then chooses among the
deterministic engines); the caller's settings come back after the body.
The counter ``step.autotuned`` counts a batch shape's first recording.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from split_vae_torch.core import tracing
from split_vae_torch.core.noise import Noise
from split_vae_torch.core.state import TrainState, tree_tensors
from split_vae_torch.parallel.mesh import Mesh

Body = Callable[[TrainState, torch.Tensor, Noise], Dict[str, torch.Tensor]]

# How many of its engines cuDNN times for each new convolution shape of a
# train step (``torch.backends.cudnn.benchmark_limit``; 0 would time every
# one). Each costs three timed runs, once a shape in a process, in the
# recording step; the fastest then runs at every step. On an H100, 5 took
# configs #2, #4 and #5's recording steps 0.5-1.6 s longer than cuDNN's
# heuristic and ran their steps in 17% less time; timing every engine took
# 2.5-5% off again, for 1-6 s of set-up, most at config #5's B=256.
AUTOTUNE_LIMIT = 5


@contextlib.contextmanager
def autotuned():
    """cuDNN's autotuner on, TF32 off; the caller's ``benchmark``,
    ``benchmark_limit``, ``deterministic`` and ``allow_tf32`` back after,
    whatever the block raised."""
    cudnn = torch.backends.cudnn
    was = (cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic, cudnn.allow_tf32)
    cudnn.benchmark, cudnn.benchmark_limit, cudnn.allow_tf32 = True, AUTOTUNE_LIMIT, False
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic, cudnn.allow_tf32 = was


class _Recorder(Noise):
    """A Noise that records each draw as it hands it out: the global shape,
    the dtype a replay of it takes and the call that makes it; the render
    seeds among them, and whether the body reads the step."""

    def __init__(self, generator, replay=None, step: int = 0):
        super().__init__(generator, replay, step=step)
        self.draws: List[Tuple[tuple, torch.dtype, Callable]] = []
        self.seeds: List[int] = []  # positions of the render seeds in ``draws``
        self.reads_step = False
        self.static = True

    def _draw(self, shape, per_example, dtype, make):
        self.draws.append((tuple(shape), dtype or self.dtype, make))
        return super()._draw(shape, per_example, dtype, make)

    def permutation(self, n):
        self.static = False
        return super().permutation(n)

    def seed(self):
        self.seeds.append(len(self.draws))
        self.draws.append(((1,), torch.int32, self.make_seed))
        return super().seed()

    def step(self):
        self.reads_step = True
        return super().step()


class _Static(Noise):
    """The Noise of a captured body: its draws, render seeds and step are the
    shape's static buffers, which are filled before each replay."""

    def __init__(self, generator, shape: "_Shape"):
        super().__init__(generator, [b for i, b in enumerate(shape.buffers)
                                     if i not in shape.seeds])
        self._seeds = [shape.buffers[i] for i in shape.seeds]
        self._static_step = shape.step

    def seed(self):
        return self._seeds.pop(0)

    def step(self):
        if self._static_step is None:  # not read when recorded: the capture fails
            raise RuntimeError("the body read the step, which its recording did not")
        return self._static_step


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
    seeds: List[int]                  # the render seeds' positions in ``draws``
    reads_step: bool
    eager: bool                       # no graph for this shape: run it eagerly
    buffers: List[torch.Tensor] = field(default_factory=list)
    step: Optional[torch.Tensor] = None  # the step's count, where the body reads it
    batch: Optional[torch.Tensor] = None
    replay: Optional[Callable[[], None]] = None
    out: Dict[str, torch.Tensor] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)


class GraphedStep:
    """``train_step(state, batch, replay=None) -> (state, metrics)`` over
    ``body`` (the module's docstring), on this process's place in ``mesh``.
    ``capture`` stands in for ``cuda_capture`` in the tests, on any device;
    without it only CUDA batches are captured."""

    def __init__(self, body: Body, mesh: Mesh = Mesh(), capture: Optional[Callable] = None):
        self.body = body
        self.mesh = mesh
        self.capture = capture or cuda_capture
        self.any_device = capture is not None
        self.shapes: Dict[tuple, _Shape] = {}

    def eager(self, state: TrainState, batch: torch.Tensor,
              replay: Optional[Sequence[torch.Tensor]] = None):
        """The step without a graph; its draws are this rank's rows of the
        global batch's."""
        noise = Noise(state.generator, replay, rank=self.mesh.data_rank,
                      world=self.mesh.data_size, step=state.step)
        return self._eager(state, batch, noise)

    def _eager(self, state: TrainState, batch: torch.Tensor, noise: Noise):
        tracing.count("step.eager")
        with tracing.span("step"), autotuned():
            return state, self.body(state, batch, noise)

    def __call__(self, state: TrainState, batch: torch.Tensor,
                 replay: Optional[Sequence[torch.Tensor]] = None):
        if (self.mesh.world > 1 or tracing.enabled() or torch.is_anomaly_enabled()
                or not (self.any_device or batch.is_cuda)):
            return self.eager(state, batch, replay)
        key = (tuple(batch.shape), batch.dtype, batch.device)
        shape = self.shapes.get(key)
        if shape is not None and shape.eager:
            return self.eager(state, batch, replay)
        if shape is None or shape.state != fingerprint(state):
            return self._record(key, state, batch, replay)
        if not self._draw(shape, state, replay):  # replayed draws that are not the recorded ones
            return self.eager(state, batch, replay)
        if shape.replay is None and not self._capture(shape, state, batch):
            return self._eager(state, batch, _Static(state.generator, shape))
        shape.batch.copy_(batch)
        shape.replay()
        state.step += 1
        tracing.count("step.graphed")
        for name, n in shape.counts.items():
            tracing.count(name, n)
        return state, {k: v.clone() for k, v in shape.out.items()}

    def _record(self, key, state, batch, replay):
        """The eager step, recording its draws for the graph of this shape."""
        noise = _Recorder(state.generator, replay, step=state.step)
        state, metrics = self._eager(state, batch, noise)
        if key not in self.shapes:
            tracing.count("step.autotuned")
        self.shapes[key] = _Shape(fingerprint(state), batch.device, noise.draws, noise.seeds,
                                  noise.reads_step, eager=not noise.static)
        return state, metrics

    def _draw(self, shape: _Shape, state: TrainState, replay) -> bool:
        """This step's inputs in the shape's buffers: the replayed draws, or
        the recorded calls made again on the state's generator, the render
        seeds drawn from it either way, and ``state.step``. False, and
        nothing drawn, where the replayed draws are not the recorded ones."""
        if not shape.buffers:
            shape.buffers = [torch.empty(s, dtype=d, device=shape.device)
                             for s, d, _ in shape.draws]
            if shape.reads_step:
                shape.step = torch.empty((), dtype=torch.float32, device=shape.device)
        if replay is not None:
            taken = [b for i, b in enumerate(shape.buffers) if i not in shape.seeds]
            replay = [torch.as_tensor(r) for r in replay]
            if len(replay) != len(taken) or any(
                    tuple(r.shape) != tuple(b.shape) for r, b in zip(replay, taken)):
                return False
            for buf, r in zip(taken, replay):
                buf.copy_(r)
        for i, (buf, (s, _, make)) in enumerate(zip(shape.buffers, shape.draws)):
            if replay is None or i in shape.seeds:
                buf.copy_(make(s))
        if shape.step is not None:
            shape.step.fill_(state.step)
        return True

    def _capture(self, shape: _Shape, state: TrainState, batch: torch.Tensor) -> bool:
        """Captures the body over static copies; False (and the shape left to
        the eager step) where the capture fails, which warns, or the body
        would put new tensors in the state. The state is as it was either
        way."""
        step, opt_state, counted = state.step, state.opt_state, tracing.counters()
        shape.batch = batch.clone()
        try:
            shape.replay, shape.out = self.capture(
                lambda: self.body(state, shape.batch, _Static(state.generator, shape)))
            kept = fingerprint(state) == shape.state
        except Exception as e:  # a body the capture cannot take: it waits for the card
            warnings.warn(f"a CUDA graph could not capture the train step of batch shape "
                          f"{tuple(batch.shape)}, which runs eagerly from now on: "
                          f"{type(e).__name__}: {e}", RuntimeWarning, stacklevel=3)
            kept = False
        after = tracing.counters()
        state.step, state.opt_state = step, opt_state
        counts = {k: v - counted.get(k, 0) for k, v in after.items() if v != counted.get(k, 0)}
        # The capture ran nothing: the first replay, or the eager step that
        # takes over, counts it.
        for name, n in counts.items():
            tracing.count(name, -n)
        if not kept:
            shape.eager, shape.replay, shape.out, shape.batch = True, None, {}, None
            return False
        shape.counts = counts
        return True
