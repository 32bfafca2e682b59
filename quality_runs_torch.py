"""Quality-metric training runs of the PyTorch port on synthetic data.

The port's counterpart of ``tools/quality_runs.py``, with its data and knobs:
the object-count accuracy of LG-SPAIR (config #5's latents) on the synthetic
Multi-Bird-Hard stand-in, and the cluster accuracy of LGGMVae (config #3) on
the synthetic SVHN digits, read from the run's ``metrics.jsonl`` beside the
JAX package's archived curves (``docs/quality/``).

Usage (on the GPU, float32 with TF32 off, as the train steps set it):
  python quality_runs_torch.py spair --z_what_beta 0.1 --steps 30000 --seed 0
  python quality_runs_torch.py gmvae --style digits --steps 30000 --seed 0
  python quality_runs_torch.py spair ... --resume <run dir>/checkpoints
  python quality_runs_torch.py verdict   # the archived curves against JAX's
  python quality_runs_torch.py early     # the early regime: collapse shares

``verdict`` reads the port's archived curves (``VERDICT_RUNS``: seeds 0-2,
``docs/quality/*_seed<s>_<n>k_steps_torch_h100.metrics.jsonl``) beside the
JAX package's and applies PERF.md's rule (section 7): at each reading the port's
seeds give [min, max] and mean +- 2 sample standard deviations; a JAX value
inside either is consistent; a fault is a JAX value outside both at both
plateau steps (20k and 30k) of the decided metric. Where a seed has not
reached a plateau step, that reading is missing and the verdict is
``undecided``: a shortfall is never read as consistent.

``early`` reads config #5's early regime (``EARLY_RUNS``: the port's seeds
0-14, the JAX package's TPU and CPU curves) by PERF.md's rule (section 7): a
run is collapsed when ``train/z_what_kl_loss`` at the step-1000 record (the
mean over steps 1-1000) lies below 60; the verdict is ``port lead`` where a
one-sided Fisher exact test gives p < 0.05 that the port collapses more often
than the pooled JAX runs, else ``platform`` where a JAX CPU run collapses and
no TPU run does, else ``no lead``; ``undecided`` where a run lacks the record.

A run writes the loop's run dir under ``--out_dir`` (``metrics.jsonl``, PNGs,
a checkpoint every 5000 steps) and prints a last ``QUALITY_RESULT {...}`` line.

The SPAIR canvases are cached under ``data/multi_cub/`` of the working
directory, keyed without the seed (as the JAX package keys them): in one
directory every seed reads the canvases of the run that made the cache, as
the JAX runs' seeds did. Runs side by side in one directory race to write
it, so make it first: ``python quality_runs_torch.py spair --data_only``
(seed 0's canvases), then start the runs.

``--resume`` restores a checkpoint; the data order then starts again from the
seed, as in the JAX loop. ``--platform cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SPAIR_KEYS = ("test0/MAE test", "test0/count_acc", "test1/MAE test", "test1/count_acc")
GMVAE_KEYS = ("test/classifier_cluster_acc", "test/classifier_recon_acc",
              "test/probe_random_z_l_acc_rangefix", "test/probe_swapped_y_z_g_acc_rangefix")
LGVAE_KEYS = ("test/classifier_recon_acc", "test/probe_random_z_l_acc_rangefix",
              "test/probe_random_z_g_acc_rangefix")


def spair_config(steps: int, batch: int, out_dir: str, model: str = "lg_spair",
                 lr: float = 1e-4, dataset: str = "cub_ckb_rot_6",
                 z_what_beta: float = 0.5, z_pres_anneal_step: float = 10_000.0,
                 seed: int = 0, z_bg_beta: float = None, bg_latent_size: int = None,
                 resume: str = None, platform: str = None):
    """The JAX driver's SPAIR run (tools/quality_runs.py:29-74): config #5's
    latents and paths for lg_spair; bg_spair's Table-1 background (z_bg_beta
    10, latent 4) unless given."""
    from split_vae_torch.core.config import SpairConfig

    lg = model == "lg_spair"
    if z_bg_beta is None:
        z_bg_beta = 1.0 if lg else 10.0
    if bg_latent_size is None:
        bg_latent_size = 64 if lg else 4
    return SpairConfig(
        seed=seed, resume=resume, platform=platform,
        model=model, dataset=dataset, batch_size=batch, learning_rate=lr,
        latent_size=64, bg_latent_size=bg_latent_size, local_latent_size=64,
        z_bg_beta=z_bg_beta, z_what_beta=z_what_beta,
        z_pres_anneal_step=z_pres_anneal_step, patch_size=8, split_z_l=lg,
        concat_z_what=lg, dense_local=lg, dense_bg=lg,
        synthetic_data=True, training_steps=steps, eval_interval=1000,
        checkpoint_interval=5_000, output_dir=out_dir, log_every=500)


def run_spair(config, sprite_contrast: float = 60.0, data_only: bool = False):
    """Trains ``config`` on 20,000 synthetic canvases with 512-image test
    splits: the loop's module-global ``get_multicub`` is bound to them, as
    the JAX driver binds its own. ``data_only`` makes their cache and stops."""
    from split_vae_torch.data.multicub import get_multicub
    from split_vae_torch.train import loop

    loop.get_multicub = functools.partial(get_multicub, n_train=20_000, n_eval=512,
                                          sprite_min_color=sprite_contrast)
    if data_only:
        loop.get_multicub(config)
        return None, SPAIR_KEYS
    _, run_dir = loop.train_spair(config)
    return run_dir, SPAIR_KEYS


def vae_config(steps: int, batch: int, out_dir: str, style: str = "blobs",
               resume: str = None, model: str = "lggmvae", seed: int = 0,
               platform: str = None):
    """The JAX driver's VAE run (tools/quality_runs.py:77-111): config #3's
    knobs (lggmvae), or the canonical SVHN LGVae (lgvae), on 8192 synthetic
    SVHN images (1024 held out)."""
    from split_vae_torch.core.config import VaeConfig

    common = dict(dataset="svhn", batch_size=batch, synthetic_data=True, synthetic_size=8192,
                  synthetic_style=style, resume=resume, training_steps=steps,
                  eval_interval=2000, checkpoint_interval=5_000, output_dir=out_dir,
                  log_every=500, seed=seed, platform=platform)
    if model == "lgvae":
        return VaeConfig(model="lgvae", beta=1.0, patch_size=1, **common)
    return VaeConfig(model="lggmvae", beta=40.0, alpha=40.0, y_size=30, patch_size=4,
                     **common)


def run_vae(config):
    from split_vae_torch.train import loop

    _, run_dir = loop.train_vae(config)
    return run_dir, LGVAE_KEYS if config.model == "lgvae" else GMVAE_KEYS


def summarize(run_dir: str, keys) -> dict:
    """Each key's (step, value) records and last value; printed on the
    ``QUALITY_RESULT`` line."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    traj = {k: [(r.get("step"), r[k]) for r in records if k in r] for k in keys}
    summary = {"run_dir": run_dir, "final": {k: v[-1] for k, v in traj.items() if v},
               "trajectory": traj}
    print("QUALITY_RESULT " + json.dumps(summary))
    return summary


QUALITY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "quality")
# config: (the port's curves, seeds 0, 1 and 2, named by the steps each run
# reached; the JAX curves; the decided metric and its readings; the reported
# metrics and their readings, None for every record).
VERDICT_RUNS = {
    "config #5 (--z_what_beta 0.1)": (
        tuple(f"lgspair_ckb_rot6_zwb01_seed{s}_30k_steps_torch_h100" for s in (0, 1, 2)),
        ("lgspair_ckb_rot6_zwb01_30k_steps", "lgspair_ckb_rot6_zwb01_seed1_30k_steps"),
        ("test0/count_acc", (20_000, 30_000)),
        (("test1/count_acc", (20_000, 30_000)), ("train/total_loss", None))),
    "config #3 (digits)": (
        tuple(f"lggmvae_digits_seed{s}_30k_steps_torch_h100" for s in (0, 1, 2)),
        ("lggmvae_digits_tpu_30k_steps",),
        ("test/classifier_cluster_acc", (10_000, 20_000, 30_000)), ()),
}
PLATEAU = (20_000, 30_000)


def read_curve(name: str, quality_dir: str = QUALITY_DIR) -> dict:
    """{key: {step: value}} of an archived metrics.jsonl."""
    curve = {}
    with open(os.path.join(quality_dir, name + ".metrics.jsonl")) as f:
        for line in f:
            record = json.loads(line)
            for k, v in record.items():
                if k not in ("step", "time"):
                    curve.setdefault(k, {})[record["step"]] = v
    return curve


def reading(port_values, jax_values) -> dict:
    """The rule at one reading: the port seeds' interval and band, and where
    each JAX value lies."""
    import numpy as np

    v = np.asarray(port_values, np.float64)
    mean = float(v.mean())
    sd = float(v.std(ddof=1)) if len(v) > 1 else float("nan")
    inside = [bool((v.min() <= j <= v.max()) or abs(j - mean) <= 2 * sd) for j in jax_values]
    return {"port": [float(x) for x in v], "mean": mean, "sd": sd, "min": float(v.min()),
            "max": float(v.max()), "jax": list(jax_values), "consistent": all(inside)}


def verdict(quality_dir: str = QUALITY_DIR) -> dict:
    """Each configuration's readings and its verdict by PERF.md's rule;
    printed as one line a reading, then ``VERDICT {...}``."""
    out = {}
    for config, (port_names, jax_names, decided, reported) in VERDICT_RUNS.items():
        port = [read_curve(name, quality_dir) for name in port_names]
        jax = [read_curve(name, quality_dir) for name in jax_names]
        rows = {}
        for key, steps in (decided,) + tuple(reported):
            if steps is None:  # every record that every curve has
                steps = sorted(set.intersection(*(set(c.get(key, {})) for c in port + jax)))
            else:  # and the last record every seed reached, where a run fell short
                last = min(max(c.get(key, {0: None})) for c in port)
                steps = sorted(set(steps) | ({last} if 0 < last < steps[-1] else set()))
            for step in steps:
                have = [c[key][step] for c in port if step in c.get(key, {})]
                if len(have) < len(port):
                    rows[(key, step)] = {"missing": len(port) - len(have)}
                    continue
                rows[(key, step)] = reading(have, [c[key][step] for c in jax])
        plateau = [rows.get((decided[0], s), {"missing": len(port)}) for s in PLATEAU]
        if any("missing" in r for r in plateau):
            decision = "undecided"
        else:
            decision = "no fault" if any(r["consistent"] for r in plateau) else "fault"
        out[config] = {"verdict": decision, "rows": rows}
        for (k, step), r in rows.items():
            print(f"{config} {k} @ {step}: " + (
                f"{r['missing']} seed(s) short" if "missing" in r else
                "port " + " / ".join(f"{x:.4f}" for x in r["port"])
                + f", mean {r['mean']:.4f}, sd {r['sd']:.4f}, JAX "
                + " / ".join(f"{x:.4f}" for x in r["jax"])
                + (" consistent" if r["consistent"] else " OUTSIDE")))
    print("VERDICT " + json.dumps({c: v["verdict"] for c, v in out.items()}))
    return out


EARLY_KEY, EARLY_TEST_KEY, EARLY_STEP = "train/z_what_kl_loss", "test0/z_what_kl_loss", 1000
COLLAPSED_BELOW = 60.0
# group: the curves of config #5 with --z_what_beta 0.1 whose step-1000 record
# is read; each seed once.
EARLY_RUNS = {
    "port": tuple(f"lgspair_ckb_rot6_zwb01_seed{s}_30k_steps_torch_h100" for s in (0, 1, 2))
    + tuple(f"lgspair_ckb_rot6_zwb01_seed{s}_1k_steps_torch_h100" for s in range(3, 15)),
    "jax_tpu": ("lgspair_ckb_rot6_zwb01_30k_steps", "lgspair_ckb_rot6_zwb01_seed1_30k_steps"),
    "jax_cpu": tuple(f"lgspair_ckb_rot6_zwb01_seed{s}_1k_steps_jax_cpu" for s in (0, 1, 2)),
}


def fisher_greater(a: int, n1: int, c: int, n2: int) -> float:
    """One-sided Fisher exact test: the probability of ``a`` or more of the
    ``a + c`` collapsed runs falling in the first sample (``n1`` runs) when
    the two samples share one rate (the hypergeometric tail)."""
    k = a + c
    tail = sum(math.comb(n1, x) * math.comb(n2, k - x) for x in range(a, min(n1, k) + 1))
    return tail / math.comb(n1 + n2, k)


def _binom_cdf(k: int, n: int, p: float) -> float:
    return sum(math.comb(n, x) * p ** x * (1 - p) ** (n - x) for x in range(k + 1))


def clopper_pearson(k: int, n: int, alpha: float = 0.05):
    """The exact (Clopper-Pearson) 1 - alpha interval of a binomial share k / n."""
    def solve(f):  # the p in [0, 1] where the decreasing f(p) crosses 0
        lo, hi = 0.0, 1.0
        for _ in range(60):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if f(mid) > 0 else (lo, mid)
        return (lo + hi) / 2

    lower = 0.0 if k == 0 else solve(lambda p: alpha / 2 - (1 - _binom_cdf(k - 1, n, p)))
    upper = 1.0 if k == n else solve(lambda p: _binom_cdf(k, n, p) - alpha / 2)
    return lower, upper


def early(quality_dir: str = QUALITY_DIR) -> dict:
    """Each run's step-1000 reading and the verdict by PERF.md's rule;
    printed as one line a run, then ``EARLY {...}``."""
    readings = {}
    for group, names in EARLY_RUNS.items():
        for name in names:
            path = os.path.join(quality_dir, name + ".metrics.jsonl")
            curve = read_curve(name, quality_dir) if os.path.exists(path) else {}
            value = curve.get(EARLY_KEY, {}).get(EARLY_STEP)
            readings[name] = {"group": group, "value": value,
                              "test": curve.get(EARLY_TEST_KEY, {}).get(EARLY_STEP),
                              "collapsed": None if value is None else value < COLLAPSED_BELOW}
            print(f"{group} {name}: " + ("no step-1000 record" if value is None else
                  f"{value:.2f} (test0 {readings[name]['test'] or float('nan'):.2f}) "
                  + ("collapsed" if value < COLLAPSED_BELOW else "not collapsed")))
    counts = {g: [sum(bool(readings[n]["collapsed"]) for n in names), len(names)]
              for g, names in EARLY_RUNS.items()}
    out = {"counts": counts, "runs": readings}
    if any(r["value"] is None for r in readings.values()):
        out["verdict"] = "undecided"
    else:
        (a, n1), jax = counts["port"], [counts["jax_tpu"], counts["jax_cpu"]]
        c, n2 = sum(x[0] for x in jax), sum(x[1] for x in jax)
        out["p"] = fisher_greater(a, n1, c, n2)
        out["share"], out["interval"] = a / n1, list(clopper_pearson(a, n1))
        if out["p"] < 0.05:
            out["verdict"] = "port lead"
        elif counts["jax_cpu"][0] > 0 and counts["jax_tpu"][0] == 0:
            out["verdict"] = "platform"
        else:
            out["verdict"] = "no lead"
    print("EARLY " + json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workload", choices=["spair", "gmvae", "verdict", "early"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--model", default="lg_spair")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--dataset", default="cub_ckb_rot_6")
    ap.add_argument("--out_dir", default="output")
    ap.add_argument("--z_what_beta", type=float, default=0.5)
    ap.add_argument("--z_pres_anneal_step", type=float, default=10_000.0)
    ap.add_argument("--sprite_contrast", type=float, default=60.0)
    ap.add_argument("--style", default="blobs", help="gmvae synthetic flavor: blobs|digits")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--z_bg_beta", type=float, default=None)
    ap.add_argument("--bg_latent_size", type=int, default=None)
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    ap.add_argument("--platform", default=None, help="cpu to run on the CPU")
    ap.add_argument("--data_only", action="store_true",
                    help="spair: make the canvases' cache and stop")
    args = ap.parse_args(argv)
    if args.workload == "verdict":
        return verdict()
    if args.workload == "early":
        return early()
    if args.workload == "spair":
        config = spair_config(args.steps or 20_000, args.batch or 256, args.out_dir,
                              model=args.model, lr=args.lr, dataset=args.dataset,
                              z_what_beta=args.z_what_beta,
                              z_pres_anneal_step=args.z_pres_anneal_step, seed=args.seed,
                              z_bg_beta=args.z_bg_beta, bg_latent_size=args.bg_latent_size,
                              resume=args.resume, platform=args.platform)
        run_dir, keys = run_spair(config, args.sprite_contrast, args.data_only)
        if run_dir is None:
            return None
    else:
        config = vae_config(args.steps or 30_000, args.batch or 64, args.out_dir,
                            style=args.style, resume=args.resume,
                            model=args.model if args.model in ("lgvae", "lggmvae")
                            else "lggmvae", seed=args.seed, platform=args.platform)
        run_dir, keys = run_vae(config)
    return summarize(run_dir, keys)


if __name__ == "__main__":
    main()
