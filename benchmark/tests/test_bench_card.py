"""The output check's control and faults on the card, at a size a test run
can hold (the limits themselves were set from ``control.py`` at the cells'
own sizes). Run on the card with ``python3 -m pytest benchmark -m card``."""

import pytest
import torch

from harness import check, data, faults, port, spec

SEEDS = (21, 22, 23)


def readings(cell, seed, device, plant=None, tf32=False):
    seeds = data.derive(seed)
    images = data.make_images(cell.config["dataset"], seeds.data, device)
    ref = check.reference_steps(cell, seeds, images, device)
    if tf32:
        return check.compare(check.reference_steps(cell, seeds, images, device, tf32=True), ref)
    prog = port.build(cell, images, seeds.state, seeds.loader, device)
    weights = check.make_weights(cell, seeds, device)
    prog.load(weights)
    draws = check.step_draws(cell, seeds, check.batch_shape(cell), device)
    return check.compare(check.program_steps(prog, weights, draws, plant), ref)


@pytest.mark.card
@pytest.mark.parametrize("name", ["tiny_spair_cell", "tiny_vae_cell"])
def test_control_and_faults_fail_where_sound_runs_pass(tiny_root, card_device, name):
    cell = spec.load_cell(name, tiny_root)
    limits = cell.own["limits"]
    for seed in SEEDS:
        sound = readings(cell, seed, card_device)
        assert check.verdict(sound, limits), sound
        control = readings(cell, seed, card_device, tf32=True)
        assert max(control[k] / max(sound[k], 1e-12) for k in ("loss_gap", "grad_gap")) > 3.0
        for fault in faults.FAULTS.values():
            assert not check.verdict(readings(cell, seed, card_device, plant=fault), limits)
    torch.cuda.synchronize()
