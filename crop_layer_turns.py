"""Wall time of the STN crop layer and of path P1's train step on one GPU,
for the checkout given as the argument (default: this one).

    python3 crop_layer_turns.py [CHECKOUT]

The crop layer is what a SPAIR step runs for its glimpses: z_where ->
``stn_crop`` -> glimpses [256, 16, 32, 32, 3] from 48-px images -> the
gradient of z_where. It is timed over 30 back-to-back calls ending in one
synchronize, and the device launches of one call are counted by
torch.profiler. The step is chip_smoke.py's path P1 (config #5, B=256): 5
warm-up steps, then three runs of 30 steps, each ending in one synchronize.
Prints one JSON line. To compare two trees, unpack the other one
(``git archive``) and run this script on each in turns, in one call on one
card: parent, change, change, parent.
"""

from __future__ import annotations

import json
import os
import sys
import time

CALLS, STEPS, RUNS = 30, 30, 3


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else here
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    from split_vae_torch.core.config import config5
    from split_vae_torch.core.state import create_train_state
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.ops.stn import stn_crop
    from split_vae_torch.train.optim import spair_optimizer
    from split_vae_torch.train.steps import make_spair_train_step, use_fp32

    use_fp32()
    g = torch.Generator(device="cuda").manual_seed(1)
    img = torch.rand((256, 48, 48, 3), generator=g, device="cuda")
    z_where = torch.randn((256, 4, 4, 4), generator=g, device="cuda", requires_grad=True)
    cot = torch.randn((256, 16, 32, 32, 3), generator=g, device="cuda")

    def layer():
        return torch.autograd.grad(stn_crop(img, z_where, (32, 32))[0], z_where, cot)

    for _ in range(5):
        layer()
    torch.cuda.synchronize()
    res = {"tree": root}
    t0 = time.perf_counter()
    for _ in range(CALLS):
        layer()
    torch.cuda.synchronize()
    res["crop layer ms a call"] = (time.perf_counter() - t0) / CALLS * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        layer()
        torch.cuda.synchronize()
    res["crop layer launches"] = sum(1 for e in prof.events()
                                     if e.device_type == torch.autograd.DeviceType.CUDA)

    cfg = config5()
    model = get_spair_model(cfg, device="cuda")
    state = create_train_state(model, spair_optimizer(cfg.learning_rate), seed=cfg.seed)
    step = make_spair_train_step(cfg)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.uniform(0, 1, (cfg.batch_size,) + tuple(cfg.image_size))
                                .astype(np.float32)).cuda() for _ in range(2)]
    for i in range(5):
        state, _ = step(state, batches[i % 2])
    torch.cuda.synchronize()
    res["P1 step ms, runs of 30"] = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        for i in range(STEPS):
            state, _ = step(state, batches[i % 2])
        torch.cuda.synchronize()
        res["P1 step ms, runs of 30"].append((time.perf_counter() - t0) / STEPS * 1e3)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
