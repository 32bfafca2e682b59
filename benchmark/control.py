"""The readings that the output check's limits are set from, on the card at
a cell's own size; not run by the benchmark's runs.

    python3 benchmark/control.py --workload <cell> --seeds 12 --faulted 4 [--first 1000]

For each seed: the checked steps of the sound program against the reference
(the lower readings); for the first ``--faulted`` seeds also the control,
the reference computed in TF32 put in the program's place, and the program
with each planted fault (``harness/faults.py``) against the reference (the
upper readings). One JSON line a reading, then a summary line: the largest
sound reading of each number and the smallest of each control and fault.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import run  # noqa: F401  (the caches' paths and sys.path, as a run sets them)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--faulted", type=int, default=4)
    p.add_argument("--first", type=int, default=1000)
    args = p.parse_args(argv)
    import torch

    from harness import check, data, faults, port, spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    shape = check.batch_shape(cell)
    rows = {}

    def program(seeds, images, plant=None):
        prog = port.build(cell, images, seeds.state, seeds.loader, device)
        weights = check.make_weights(cell, seeds, device)
        prog.load(weights)
        draws = check.step_draws(cell, seeds, shape, device)
        got = check.program_steps(prog, weights, draws, plant)
        del prog, weights, draws
        gc.collect()
        torch.cuda.empty_cache()
        return got

    for i in range(args.seeds):
        seed = args.first + i
        seeds = data.derive(seed)
        images = data.make_images(cell.config["dataset"], seeds.data, device)
        sound = program(seeds, images)
        ref = check.reference_steps(cell, seeds, images, device)
        sides = {"sound": sound}
        if i < args.faulted:
            sides["control_tf32"] = check.reference_steps(cell, seeds, images, device, tf32=True)
            for name, plant in faults.FAULTS.items():
                sides[name] = program(seeds, images, plant)
        for side, got in sides.items():
            numbers = check.compare(got, ref)
            rows.setdefault(side, []).append(numbers)
            print(json.dumps({"seed": seed, "side": side, "numbers": numbers,
                              "losses": got.losses, "reference": ref.losses}), flush=True)
        del images, ref, sides
        gc.collect()
        torch.cuda.empty_cache()
    summary = {side: {k: (max if side == "sound" else min)(r[k] for r in rs) for k in rs[0]}
               for side, rs in rows.items()}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
