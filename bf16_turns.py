"""Train-step wall time in float32 and in bfloat16, in turns, on one GPU.

    python3 bf16_turns.py

Builds chip_smoke.py's paths P1 (config #5, LG-SPAIR, B=256) and P5 (config
#2, LGVae, B=64) twice each, in float32 and with ``compute_dtype="bfloat16"``
(P10, P11), from the same seed, and runs them in PAIRS pairs of turns of
STEPS steps, the float32 side first in even pairs and the bfloat16 side first
in odd ones; each turn follows a ``gc.collect()`` and ends in one
synchronize. Prints the card (``nvidia-smi``), then one JSON line per
configuration: each side's step ms by turn, their medians and quartiles, and
the pairs the bfloat16 side won.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

PAIRS, STEPS, WARMUP = 10, 20, 3


def quartiles(v):
    q = statistics.quantiles(v, n=4)
    return [q[0], q[2]]


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    from split_vae_torch.core.config import CONFIG2_IMAGE_HW, config2, config5
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.loop import build_vae_model
    from split_vae_torch.train.optim import spair_optimizer
    from split_vae_torch.train.steps import make_spair_train_step, make_vae_train_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    rng = np.random.RandomState(0)

    def spair(dtype):
        cfg = config5(compute_dtype=dtype)
        model = get_spair_model(cfg, device="cuda")
        state = create_train_state(model, spair_optimizer(cfg.learning_rate), seed=cfg.seed)
        return make_spair_train_step(cfg), state

    def vae(dtype):
        cfg = config2(compute_dtype=dtype)
        model, tx = build_vae_model(cfg, CONFIG2_IMAGE_HW, device="cuda")
        return make_vae_train_step(cfg), create_train_state(model, tx, seed=cfg.seed)

    cases = {
        "config #5 (P1, P10), B=256": (spair, [torch.from_numpy(
            rng.uniform(0, 1, (256, 48, 48, 3)).astype(np.float32)).cuda() for _ in range(2)]),
        "config #2 (P5, P11), B=64": (vae, [torch.from_numpy(
            rng.randint(0, 255, (64, 64, 64, 3)).astype(np.uint8)).cuda() for _ in range(2)]),
    }
    for name, (build, batches) in cases.items():
        sides = {dtype: list(build(dtype)) for dtype in ("float32", "bfloat16")}

        def turn(dtype, steps):
            step, state = sides[dtype]
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                state, metrics = step(state, batches[i % 2])
            torch.cuda.synchronize()
            sides[dtype][1] = state
            if not torch.isfinite(metrics["total_loss"]):
                sys.exit(f"{name} {dtype}: non-finite loss")
            return (time.perf_counter() - t0) / steps * 1e3

        for dtype in sides:
            turn(dtype, WARMUP)
        ms = {dtype: [] for dtype in sides}
        for p in range(PAIRS):
            order = ("float32", "bfloat16") if p % 2 == 0 else ("bfloat16", "float32")
            for dtype in order:
                ms[dtype].append(turn(dtype, STEPS))
        print(json.dumps({
            "case": name, "steps_a_turn": STEPS, "step_ms": ms,
            "median_ms": {d: statistics.median(v) for d, v in ms.items()},
            "quartiles_ms": {d: quartiles(v) for d, v in ms.items()},
            "bf16_wins": sum(b < f for f, b in zip(ms["float32"], ms["bfloat16"])),
            "pairs": PAIRS}))
        del sides
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
