"""Data parallelism of the port (split_vae_torch/parallel/mesh.py) on the CPU.

The JAX package's contract (tests/test_sharding.py): the sharded step equals
the single-device step. Here an N-rank step of the port at a global batch
equals its 1-rank step at that batch, the noise drawn and not replayed:

- the mesh rules: no process group unless more than one process is asked
  for, a failure to initialize propagates, a model count that does not
  divide the world and a data count other than the world are refused, each
  rank's rows;
- the draws: a per-example draw of each rank is its rows of the 1-rank draw;
  a shared one is the 1-rank draw; replayed draws are sliced alike;
- the data: the per-process slices of ``iterate_batches`` are the JAX
  package's, index for index; the ranks' rows of ``device_resident_batches``
  are the 1-rank batch;
- one train step in 2 gloo processes (LGVae, LGGMVae, LG-SPAIR with the
  plain render and crop and render noise 0.01) against the 1-rank step:
  the loss (the ranks' mean) at rtol 1e-4; the ranks' parameters bit-equal;
  the gradients the optimizer saw at rtol 1e-3, atol 1e-6 max|g|; the
  parameters after Adam at atol 1e-5 where |g| >= 1e-5 (elsewhere Adam's
  first step turns a reduction-order difference of a near-zero gradient
  into an update difference of up to lr, so there only the gradient is
  held); LGGMVae's parameters at atol 5e-4, the JAX test's own
  (tests/test_sharding.py:316-327). Rank 1 builds its model and generator
  from another seed, so the step also holds ``broadcast_state_``;
- ``vae_main`` in 2 processes through ``--coordinator``, ``--num_processes``
  and ``--process_id`` (4 steps, an eval and a checkpoint at step 2) against
  the 1-process run: one run directory, rank 0's records, the checkpoint
  (each tensor's displacement from the seeded initialization and Adam's
  moments in the L2 norm, which a wrong gradient at any step moves), and
  ``--resume`` from step 2.

The children run in processes of their own (``spawn_ranks``): one torch
thread each, a free port from a bound socket, and a time limit, so a hung
rank fails the test. The slice against the JAX package's sharded step is
``tests/test_torch_parallel_jax.py``.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from split_vae_torch.core.config import config5, parse_vae_args  # noqa: E402
from split_vae_torch.core.config import VaeConfig  # noqa: E402
from split_vae_torch.core.noise import Noise  # noqa: E402
from split_vae_torch.core.state import create_train_state  # noqa: E402
from split_vae_torch.data.loader import ArrayDataset  # noqa: E402
from split_vae_torch.data.loader import device_resident_batches  # noqa: E402
from split_vae_torch.data.loader import iterate_batches  # noqa: E402
from split_vae_torch.parallel import mesh as mesh_mod  # noqa: E402
from split_vae_torch.parallel.mesh import Mesh, rows  # noqa: E402
from split_vae_torch.train.optim import GradientTransformation, spair_optimizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
CHILD_TIMEOUT = 150  # seconds; a hung rank fails the test instead of the whole run


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(jobs, out_dir, cwd, meanwhile, world=WORLD):
    """Runs ``child(rank, ...)`` in ``world`` processes of their own, and
    ``meanwhile()`` here while they run; returns each rank's results, {job:
    result}, and what ``meanwhile`` returned. A failed or late rank fails."""
    port = free_port()
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import test_torch_parallel as t; "
            "t.child({{}}, {}, {}, {!r}, {!r})").format(REPO, HERE, world, port, out_dir,
                                                         ",".join(jobs))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", code.format(r)], cwd=cwd, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        here = meanwhile()
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" + "\n".join(
            log[-3000:] for log in logs)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)], here


def child(rank, world, port, out_dir, jobs) -> None:
    """A rank's body: joins the gloo group (the CLI job joins it through its
    flags), runs the jobs, saves {job: result} to ``out_dir/rank<r>.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    results = {}
    jobs = jobs.split(",")
    if "cli" in jobs:
        results["cli"] = cli_job(rank, world, port)
    mesh_mod.maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = mesh_mod.create_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.backend) == (rank, world, "gloo"), mesh
    for job in jobs:
        if job != "cli":
            results[job] = JOBS[job](mesh, out_dir)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------- train steps

B = 8  # the global batch of the VAE steps; 4 rows a rank
VAE_HW = (16, 16)
VAE_CONFIGS = {
    "lgvae": VaeConfig(model="lgvae", batch_size=B, patch_size=2, beta=1.0,
                       global_latent_dims=8, local_latent_dims=8),
    "lggmvae": VaeConfig(model="lggmvae", batch_size=B, patch_size=2, beta=2.0, alpha=1.0,
                         y_size=6, tau=0.4, global_latent_dims=8, local_latent_dims=8),
}
SPAIR_B, SPAIR_HW = 4, 24  # 2x2 cells, 2 rows a rank


def spair_config():
    cfg = config5(batch_size=SPAIR_B, latent_size=8, bg_latent_size=8, local_latent_size=8,
                  object_size=16)
    cfg.image_size = (SPAIR_HW, SPAIR_HW, 3)
    return cfg


def recording(tx: GradientTransformation, seen: list) -> GradientTransformation:
    """``tx`` that also keeps the gradients it is handed (the reduced ones)."""
    def update(grads, state):
        seen.append([g.detach().clone() for g in grads])
        return tx.update(grads, state)

    return GradientTransformation(tx.init, update)


def run_step(kind: str, mesh: Mesh, out_dir=None):
    """One train step of ``kind`` on this rank's rows of the seeded global
    batch; the model and generator from seed + rank, then rank 0's state."""
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.loop import build_vae_model
    from split_vae_torch.train.steps import make_spair_train_step, make_vae_train_step

    seen = []
    seed = 3 + mesh.rank
    if kind == "lg_spair":
        cfg = spair_config()
        model = get_spair_model(cfg.replace(seed=seed), device="cpu")
        tx = spair_optimizer(cfg.learning_rate)
        batch = np.random.RandomState(0).uniform(0, 1, (SPAIR_B, SPAIR_HW, SPAIR_HW, 3))
        batch = torch.from_numpy(batch.astype(np.float32))
        step = make_spair_train_step(cfg, mesh=mesh)
    else:
        cfg = VAE_CONFIGS[kind]
        model, tx = build_vae_model(cfg.replace(seed=seed), VAE_HW, device="cpu")
        batch = torch.from_numpy(np.random.RandomState(0).randint(0, 255, (B, *VAE_HW, 3))
                                 .astype(np.uint8))
        step = make_vae_train_step(cfg, mesh)
    state = create_train_state(model, recording(tx, seen), seed=seed)
    mesh_mod.broadcast_state_(state, mesh)
    state, metrics = step(state, batch[rows(mesh, batch.shape[0])])
    return {"loss": float(metrics["total_loss"]), "notfinite": float(metrics["notfinite_updates"]),
            "params": [p.detach().clone() for p in model.parameters()], "grads": seen[0],
            "step": state.step}


def replay_step(mesh: Mesh, out_dir: str):
    """tests/test_torch_parallel_jax.py's rank: the LG-SPAIR step on the
    converted parameters with the JAX package's draws replayed at the global
    shape (``out_dir/jax_inputs.pt``), render noise 0."""
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.steps import make_spair_train_step

    inputs = torch.load(os.path.join(out_dir, "jax_inputs.pt"), weights_only=False)
    cfg = spair_config()
    model = get_spair_model(cfg, device="cpu")
    model.load_state_dict(inputs["params"])
    model.render_noise_scale = 0.0
    state = create_train_state(model, spair_optimizer(cfg.learning_rate), seed=0)
    x = inputs["x"]
    state, metrics = make_spair_train_step(cfg, mesh=mesh)(state, x[rows(mesh, x.shape[0])],
                                                            inputs["replay"])
    return {"loss": float(metrics["total_loss"]), "step": state.step,
            "params": {k: v.clone() for k, v in model.state_dict().items()}}


JOBS = {kind: functools.partial(run_step, kind) for kind in ("lgvae", "lggmvae", "lg_spair")}
JOBS["jax_replay"] = replay_step


@pytest.fixture(scope="module")
def ranks_and_one(tmp_path_factory):
    """The 2-rank children (the CLI runs and the steps), and meanwhile the
    1-rank references in this process: the steps, then vae_main's run and
    resume in a directory of their own."""
    from split_vae_torch.train import loop

    out = str(tmp_path_factory.mktemp("ranks"))
    cwd2, cwd1 = (str(tmp_path_factory.mktemp(n)) for n in ("cli2", "cli1"))

    def one_rank():
        threads, home = torch.get_num_threads(), os.getcwd()
        torch.set_num_threads(1)
        os.chdir(cwd1)
        try:
            steps = {kind: run_step(kind, Mesh()) for kind in ("lgvae", "lggmvae", "lg_spair")}
            _, run = loop.train_vae(parse_vae_args(CLI_ARGV))
            _, resumed = loop.train_vae(parse_vae_args(
                CLI_ARGV + ["--resume", os.path.join(run, "checkpoints", "checkpoint_2.pt")]))
        finally:
            os.chdir(home)
            torch.set_num_threads(threads)
        return steps, os.path.join(cwd1, run), os.path.join(cwd1, resumed)

    results, (one, run1, resumed1) = spawn_ranks(["cli", "lgvae", "lggmvae", "lg_spair"], out,
                                                 cwd2, one_rank)
    return results, one, cwd2, run1, resumed1


def hold_params_by_gradient(one, many, atol=1e-5):
    for name, (p1, pn, g1) in enumerate(zip(one["params"], many["params"], one["grads"])):
        held = g1.abs() >= 1e-5
        np.testing.assert_allclose(pn[held].numpy(), p1[held].numpy(), rtol=0, atol=atol,
                                   err_msg=f"parameter {name}")


@pytest.mark.parametrize("kind", ["lgvae", "lggmvae", "lg_spair"])
def test_n_rank_step_equals_one_rank_step(ranks_and_one, kind):
    results, one = ranks_and_one[:2]
    one, many = one[kind], [r[kind] for r in results]
    assert [m["step"] for m in many] == [1] * WORLD and one["step"] == 1
    assert all(m["notfinite"] == 0 for m in many)
    loss = sum(m["loss"] for m in many) / WORLD
    np.testing.assert_allclose(loss, one["loss"], rtol=1e-4)
    for p0, p1 in zip(many[0]["params"], many[1]["params"]):
        assert torch.equal(p0, p1)  # every rank took the same update
    for g0, g1 in zip(many[0]["grads"], many[1]["grads"]):
        assert torch.equal(g0, g1)  # the all-reduce gave every rank the same mean
    if kind == "lggmvae":
        for i, (p1, pn) in enumerate(zip(one["params"], many[0]["params"])):
            np.testing.assert_allclose(pn.numpy(), p1.numpy(), rtol=0, atol=5e-4,
                                       err_msg=f"parameter {i}")
        return
    for i, (g1, gn) in enumerate(zip(one["grads"], many[0]["grads"])):
        np.testing.assert_allclose(gn.numpy(), g1.numpy(), rtol=1e-3,
                                   atol=1e-6 * g1.abs().max().item(), err_msg=f"gradient {i}")
    hold_params_by_gradient(one, many[0])


# ---------------------------------------------------------------- the CLI

CLI_ARGV = ["--platform", "cpu", "-synthetic_data", "--synthetic_size", "32",
            "--dataset", "celeba64", "-no_label", "--beta", "30", "--patch_size", "8",
            "--global_latent_dims", "8", "--local_latent_dims", "8", "--batch_size", "8",
            "--eval_interval", "2", "--checkpoint_interval", "2", "--training_steps", "4"]


def cli_job(rank, world, port):
    """vae_main in this rank: 4 steps, then --resume from step 2 to step 4.
    Returns the run directories after the first run and after the resume."""
    from split_vae_torch.cli import vae_main

    flags = ["--coordinator", f"127.0.0.1:{port}", "--num_processes", str(world),
             "--process_id", str(rank)]
    import torch.distributed as dist

    vae_main.main(CLI_ARGV + flags)
    dist.barrier()  # rank 0 has written its last file
    first = sorted(os.listdir("output"))
    dist.barrier()  # every rank has looked before rank 0 makes the resume's directory
    ckpt = os.path.join("output", first[0], "checkpoints", "checkpoint_2.pt")
    vae_main.main(CLI_ARGV + flags + ["--resume", ckpt])
    dist.barrier()
    return {"first": first, "all": sorted(os.listdir("output"))}


def records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def hold_records(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k not in ("step", "time", "train/imgs_per_sec"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"step {w['step']} {k}")


# The optimizer state's tolerance at a checkpoint, a fraction of each
# tensor's largest magnitude. After 2 steps the 2-process state lies within
# 2.8e-5 of the 1-process state; after 4 steps within 5.1e-3, and so do two
# 1-process runs that differ only in their torch thread count (the order of
# the sums, amplified by the steps: Adam's early updates of near-zero
# gradients move the parameters, and the recon loss, a sum over 12,288
# pixels, turns that into gradient differences).
OPT_ATOL = {2: 1e-4, 4: 1e-2}
# The same in the L2 norm of each tensor, which an element flipped by Adam
# near eps moves little and a wrong gradient at any step moves by its whole
# share: the parameters' displacement from the seeded initialization, ||(p2
# - p0) - (p1 - p0)|| / ||p1 - p0||, read at most 6.2e-6 after 2 steps and
# 4.9e-4 after 4; Adam's moments, ||m2 - m1|| / ||m1||, 1.8e-5 and 1.7e-3.
DISPLACEMENT_RTOL = {2: 1e-4, 4: 5e-3}
MOMENT_RTOL = {2: 2e-4, 4: 1e-2}


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def hold_checkpoints(got, want, steps, argv=None):
    """The step; the parameters after ``steps`` Adam updates within steps *
    lr (an update moves a parameter by about lr at most, which a near-zero
    gradient's reduction order can flip; see the module docstring); the
    optimizer state at OPT_ATOL[steps] of each tensor's largest magnitude;
    each tensor's displacement from the initialization of ``argv`` (the
    CLI's seeded build) at DISPLACEMENT_RTOL[steps] and the moments at
    MOMENT_RTOL[steps], in the L2 norm."""
    from split_vae_torch.train.loop import build_vae_model

    g, w = (torch.load(p, weights_only=True) for p in (got, want))
    assert g["step"] == w["step"] == steps
    init, _ = build_vae_model(parse_vae_args(argv or CLI_ARGV), (64, 64), "cpu")
    for name, p0 in init.state_dict().items():
        gap = rel_l2(g["model"][name] - p0, w["model"][name] - p0)
        assert gap <= DISPLACEMENT_RTOL[steps], f"{name}: displacement {gap:.3g} apart"
    for i, (a, b) in enumerate(zip(g["opt_state"], w["opt_state"])):
        if b.dim():
            assert rel_l2(a, b) <= MOMENT_RTOL[steps], f"optimizer tensor {i}: {rel_l2(a, b):.3g}"
    for name in w["model"]:
        np.testing.assert_allclose(g["model"][name].numpy(), w["model"][name].numpy(), rtol=0,
                                   atol=steps * 1e-4, err_msg=name)
    for i, (a, b) in enumerate(zip(g["opt_state"], w["opt_state"])):
        b = b.double()
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=0,
                                   atol=OPT_ATOL[steps] * b.abs().max().item(),
                                   err_msg=f"optimizer tensor {i}")


def test_vae_main_in_two_processes_equals_one(ranks_and_one):
    results, _, cwd2, run1, resumed1 = ranks_and_one
    cli = [r["cli"] for r in results]
    assert cli[0] == cli[1] and len(cli[0]["first"]) == 1 and len(cli[0]["all"]) == 2
    run2 = os.path.join(cwd2, "output", cli[0]["first"][0])
    resumed2 = os.path.join(cwd2, "output", [d for d in cli[0]["all"]
                                             if d not in cli[0]["first"]][0])
    hold_records(records(run2), records(run1))
    hold_records(records(resumed2), records(resumed1))
    for step in (2, 4):
        hold_checkpoints(os.path.join(run2, "checkpoints", f"checkpoint_{step}.pt"),
                         os.path.join(run1, "checkpoints", f"checkpoint_{step}.pt"), step)
    assert os.path.isfile(os.path.join(cwd2, "models", cli[0]["first"][0] + ".pt"))


# ---------------------------------------------------------------- mesh rules

@pytest.fixture
def no_torchrun_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)


def test_maybe_initialize_distributed_noop_single_host(monkeypatch, no_torchrun_env):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    mesh_mod.maybe_initialize_distributed(None, None, None)
    mesh_mod.maybe_initialize_distributed(None, 1, None)
    mesh_mod.maybe_initialize_distributed(None, 0, 0)
    assert calls == []
    mesh_mod.maybe_initialize_distributed("host:1234", 2, 0, backend="gloo")
    assert calls == [(("gloo",), dict(init_method="tcp://host:1234", world_size=2, rank=0))]
    # torchrun's environment, with no flags
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    mesh_mod.maybe_initialize_distributed(backend="gloo")
    assert calls[1] == (("gloo",), dict(init_method="tcp://10.0.0.1:29500", world_size=4,
                                        rank=3))


def test_maybe_initialize_distributed_propagates_real_failures(monkeypatch, no_torchrun_env):
    def refused(*args, **kwargs):
        raise RuntimeError("connection to coordinator refused")

    monkeypatch.setattr(torch.distributed, "init_process_group", refused)
    with pytest.raises(RuntimeError, match="coordinator"):
        mesh_mod.maybe_initialize_distributed("badhost:1", 2, 0, backend="gloo")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh_mod.maybe_initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="process_id"):
        mesh_mod.maybe_initialize_distributed("host:1", 2, None)
    assert not torch.distributed.is_initialized()


def test_defaults_need_cuda(monkeypatch, no_torchrun_env):
    """With no device or backend asked for, the mesh takes cuda:{local rank}
    and the group NCCL: without CUDA both raise, and the group before any
    rendezvous, rather than go on over the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("joined a group"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.create_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.maybe_initialize_distributed("host:1234", 2, 0)
    assert mesh_mod.create_mesh(device="cpu").device == torch.device("cpu")


def test_create_mesh_rules(no_torchrun_env):
    assert mesh_mod.create_mesh(device="cpu") == Mesh(0, 1, 0, torch.device("cpu"), None)
    assert mesh_mod.create_mesh(num_data=1, device="cpu").world == 1
    with pytest.raises(ValueError, match="A8"):  # 2 model ranks in a world of 1
        mesh_mod.create_mesh(num_model=2)
    with pytest.raises(ValueError, match="world size, 1"):
        mesh_mod.create_mesh(num_data=2)


def test_rows():
    assert [rows(Mesh(rank=r, world=4), 12) for r in range(4)] == [
        slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)]
    assert rows(Mesh(), 7) == slice(0, 7)
    with pytest.raises(ValueError, match="divide evenly over 4"):
        rows(Mesh(rank=0, world=4), 10)


def test_one_rank_does_no_collective():
    t = [torch.ones(3)]
    mesh_mod.all_reduce_mean_(t, Mesh())  # no process group exists: a collective would raise
    assert torch.equal(t[0], torch.ones(3))
    assert mesh_mod.all_reduce_mean_values([1.5, 2.0], Mesh()) == [1.5, 2.0]
    assert mesh_mod.broadcast_object("run", Mesh()) == "run"


# ---------------------------------------------------------------- draws

def _draws(noise: Noise):
    return [noise.normal((4, 3), per_example=True), noise.uniform((4, 2), per_example=True),
            noise.permutation(5), noise.keep((4, 6), 0.3, per_example=True),
            noise.randint(7, (4,), per_example=True), noise.normal((2,), per_example=False),
            noise.image_seed(4)]


def test_per_example_draws_are_the_ranks_rows_of_the_one_rank_draws():
    """Two ranks of 4 rows against one rank of the global 8."""
    ranks = [_draws(Noise(torch.Generator().manual_seed(5), rank=r, world=2)) for r in range(2)]
    one = Noise(torch.Generator().manual_seed(5))
    want = [one.normal((8, 3)), one.uniform((8, 2)), one.permutation(5),
            one.keep((8, 6), 0.3), one.randint(7, (8,)), one.normal((2,)), one.seed()]
    for i in (0, 1, 3, 4):  # per example: the ranks' rows
        assert torch.equal(torch.cat([r[i] for r in ranks]), want[i]), i
    for i in (2, 5):  # shared: the same on every rank
        assert torch.equal(ranks[0][i], want[i]) and torch.equal(ranks[1][i], want[i]), i
    # the render seed: rank r adds r * its rows, wrapping as the kernels' uint32 does
    assert int(ranks[0][6]) == int(want[6]) and int(ranks[1][6]) == int(want[6]) + 4
    near_top = Noise(torch.Generator().manual_seed(0), rank=3, world=4)
    near_top.seed = lambda: torch.tensor([2**31 - 2], dtype=torch.int32)
    assert int(near_top.image_seed(4)) == (2**31 - 2 + 12) - 2**32


def test_replayed_draws_are_global_and_sliced():
    eps = torch.arange(24.0).reshape(8, 3)
    perm = torch.tensor([2, 0, 1])
    for r in range(2):
        noise = Noise(torch.Generator(), [eps, perm], rank=r, world=2)
        assert torch.equal(noise.normal((4, 3), per_example=True), eps[4 * r:4 * r + 4])
        assert torch.equal(noise.permutation(3), perm)
        assert noise.exhausted()
    with pytest.raises(ValueError, match="per example"):
        Noise(torch.Generator(), rank=0, world=2).normal((4, 3))


# ---------------------------------------------------------------- data

def test_per_process_slices_are_the_jax_packages():
    from split_vae_tpu.data.loader import iterate_batches as jax_iterate_batches

    n, n_proc, bs = 103, 4, 5
    ds = ArrayDataset(images=np.arange(n, dtype=np.int64).reshape(n, 1, 1, 1))
    seen = []
    for k in range(n_proc):
        mine = [b.ravel() for b in iterate_batches(ds, bs, seed=7, process_index=k,
                                                   process_count=n_proc)]
        theirs = [np.asarray(b).ravel() for b in jax_iterate_batches(
            ds, bs, seed=7, process_index=k, process_count=n_proc)]
        assert len(mine) == len(theirs) == 5
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
        seen.append(np.concatenate(mine))
    every = np.concatenate(seen)
    assert len(np.unique(every)) == len(every) == n_proc * 25  # disjoint, each kept once
    kept = np.random.RandomState(7).permutation(n)[:n_proc * (n // n_proc)]
    np.testing.assert_array_equal(np.sort(every), np.sort(kept))


def test_resident_rows_are_the_one_rank_batch():
    n = 37
    ds = ArrayDataset(images=np.arange(n * 4, dtype=np.float32).reshape(n, 2, 2, 1),
                      labels=np.arange(n, dtype=np.int32))
    one = list(device_resident_batches(ds, 8, seed=5, device="cpu"))
    ranks = [list(device_resident_batches(ds, 8, seed=5, device="cpu",
                                          rows=rows(Mesh(rank=r, world=4), 8)))
             for r in range(4)]
    assert len(one) == 4 and all(len(r) == 4 for r in ranks)
    for i, (imgs, labels) in enumerate(one):
        assert torch.equal(torch.cat([r[i][0] for r in ranks]), imgs)
        assert torch.equal(torch.cat([r[i][1] for r in ranks]), labels)
