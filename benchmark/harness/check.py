"""Whether the timed path trains as the reference does.

Set-up builds one program (``port.build``) and drives it from the seed
through its first ``CHECKED_STEPS`` steps, through the window's own call on
the loader's batches, with the step's random draws handed in (``replay``:
the same tensors the reference takes); the same object then goes on into
the window. What the state keeps is read as it goes: each step's loss, the
first gradient as Adam took it (mu / (1 - b1) after one step) and the
parameters' change after the last checked step. Once the window has closed
and the program is freed, the frozen reference takes the same steps from the
same weights, rows and draws, working out the render's seeds as the
program's generator draws them; then ``compare`` gives the numbers:

- ``batch_gap``: the largest difference between a row the loader served and
  the reference's row (exact: limit 0);
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first gradient, over the larger of the
  reference leaf's norm and the median leaf's;
- ``change_gap``: the same of the parameters' change, leaving out the leaves
  whose first gradient in the reference is under a thousandth of the median
  leaf's (they move by round-off alone under Adam).
"""

from __future__ import annotations

import importlib
import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from . import data, port

CHECKED_STEPS = 3
B1 = 0.9  # Adam's first-moment decay, Keras's and the reference's
STILL = 1e-3  # a leaf whose first gradient is under this share of the median leaf's


def reference_module(cell):
    return importlib.import_module(f"reference.{cell.config['reference']}")


@dataclass
class Readings:
    """One side's readings of the checked steps, by leaf name."""

    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    batches: List[torch.Tensor] = field(default_factory=list)
    flops: Optional[float] = None  # of the first step, forward and backward


def leaf_norms(names, tensors, scale: float = 1.0) -> Dict[str, float]:
    norms = torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]) * scale
    return dict(zip(names, norms.tolist()))


def step_draws(cell, seeds: data.Seeds, shape, device) -> List[List[torch.Tensor]]:
    """The checked steps' draws, made from the seed."""
    ref = reference_module(cell)
    gen = torch.Generator(device=device).manual_seed(seeds.draws)
    return [ref.draws(cell.config["config"], shape, gen) for _ in range(CHECKED_STEPS)]


def render_seeds(seeds: data.Seeds, device) -> List[int]:
    """The render's seed of each checked step: one int32 in [0, 2^31 - 1) a
    step from the program's generator, seeded with ``seeds.state``; under
    replayed draws it is the only draw that generator makes."""
    gen = torch.Generator(device=device).manual_seed(seeds.state)
    return [int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=device,
                              dtype=torch.int32)) for _ in range(CHECKED_STEPS)]


def batch_shape(cell):
    return (cell.traffic["batch_size"],) + tuple(cell.config["dataset"]["shape"])


def program_steps(prog: port.Program, weights: Dict[str, torch.Tensor], draws,
                  plant: Optional[Callable] = None) -> Readings:
    """The checked steps through the program: the window's call on the
    loader's batches, the draws replayed. ``plant`` wraps the step (a fault
    put in on purpose, to see the check fail)."""
    step = plant(prog.step) if plant else prog.step
    losses, batches, grad_norms = [], [], None
    for i in range(CHECKED_STEPS):
        batch = next(prog.batches)
        batches.append(batch.cpu())  # off the card, so the window's peak is the program's
        prog.state, m = step(prog.state, batch, replay=draws[i])
        prog.metrics.update(m)
        losses.append(m["total_loss"])
        if i == 0:
            grad_norms = leaf_norms(prog.names, prog.adam_state().mu, 1.0 / (1.0 - B1))
    params = dict(prog.state.model.named_parameters())
    change = leaf_norms(prog.names, [params[n].detach() - weights[n] for n in prog.names])
    return Readings([float(v) for v in losses], grad_norms, change, batches)


def reference_steps(cell, seeds: data.Seeds, images: np.ndarray, device,
                    tf32: bool = False, count_flops: bool = False) -> Readings:
    """The checked steps through the frozen reference, from what the seed
    makes: the weights, the rows the loader serves first, the draws, the
    render's seeds. ``tf32`` computes its matrix products and convolutions
    in TF32 (the control: the next precision below float32 with TF32 off).
    ``count_flops`` counts the first step's convolutions and matrix products,
    forward and backward (``torch.utils.flop_counter``): the model's maths,
    since the reference's crop and paste gather their taps and multiply no
    matrices."""
    ref = reference_module(cell)
    shape = batch_shape(cell)
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        step = ref.Step(cell.config["config"], make_weights(cell, seeds, device), device,
                        tuple(shape[1:3]))
        weights = {n: p.detach().clone() for n, p in zip(step.names, step.params)}
        draws = step_draws(cell, seeds, shape, device)
        rows = data.first_rows(len(images), shape[0], seeds.loader, CHECKED_STEPS)
        losses, batches, grad_norms, flops = [], [], None, None
        for i, (idx, seed) in enumerate(zip(rows, render_seeds(seeds, device))):
            batch = torch.from_numpy(images[idx]).to(device)
            batches.append(batch)
            if count_flops and i == 0:
                with FlopCounterMode(display=False) as counter:
                    loss, taken = step.run(batch, draws[i], seed)
                flops = float(counter.get_total_flops())
            else:
                loss, taken = step.run(batch, draws[i], seed)
            losses.append(loss)
            if i == 0:
                grad_norms = leaf_norms(step.names, taken)
        change = leaf_norms(step.names, [p.detach() - weights[n]
                                         for n, p in zip(step.names, step.params)])
    finally:
        torch.set_float32_matmul_precision(was[2])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was[:2]
    return Readings(losses, grad_norms, change, batches, flops)


def make_weights(cell, seeds: data.Seeds, device) -> Dict[str, torch.Tensor]:
    """The benchmark's initial weights, by name, of the reference model's
    parameters (the program's must have the same names and shapes)."""
    ref = reference_module(cell)
    common = importlib.import_module("reference.common")
    with torch.device("meta"):
        model = ref.model(cell.config["config"], tuple(cell.config["dataset"]["shape"][:2]))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return common.init_weights(shapes, seeds.weights, device)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], skip=()) -> float:
    keep = [n for n in ref if n not in skip]
    floor = statistics.median(ref[n] for n in keep)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor) for n in keep)


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers of the check (the module's docstring)."""
    floor = statistics.median(ref.grad_norms.values())
    still = {n for n, v in ref.grad_norms.items() if v < STILL * floor}
    batch_gap = max(float((a.cpu().float() - b.cpu().float()).abs().max())
                    for a, b in zip(prog.batches, ref.batches)) if prog.batches else 0.0
    return {
        "batch_gap": batch_gap,
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)),
        "grad_gap": leaf_gap(prog.grad_norms, ref.grad_norms),
        "change_gap": leaf_gap(prog.change_norms, ref.change_norms, skip=still),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number is finite and within its limit."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
