"""Tensor parallelism of the port (split_vae_torch/parallel/) on the CPU.

The JAX package's contract (tests/test_sharding.py): a step sharded over a
('data', 'model') mesh equals the single-device step. Here a step of the port
over a grid of gloo ranks, 1 x 2 and 2 x 2 (data x model), equals its 1-rank
step at the same global batch, the noise drawn and not replayed:

- the grid: rank r at data index r // num_model and model index
  r % num_model; the refusals (a model count that does not divide the world,
  a data count whose product with it is not the world); the rows follow the
  data index;
- the placement, in one process: the sharded weights keep their block of
  dim 0, Adam's moments their parameter's block, the counts are whole
  (tests/test_sharding.py:132-176);
- one train step of LGVae, LGGMVae and LG-SPAIR (the plain render and crop,
  render noise 0.01, ``min_size`` small enough that each model shards Dense
  and Conv weights) in both grids against the 1-rank step
  (tests/test_torch_parallel.py's ``run_step``): the loss at rtol 1e-4; the
  gathered gradients the optimizer saw at rtol 1e-3, atol 1e-6 max|g|; the
  gathered parameters at Adam's rule; the
  ranks of a model index bit-equal, and every rank's gathered parameters;
- a sharded fused ``Resize2xConv`` (3x3, h != w) and ``Resize2xConvAny``
  (6x6) over the 1 x 2 grid equal to the whole layer: the output and the
  gradients of the input, the gathered weight and the bias (rtol 1e-5);
- the traps: a sharded gradient whose block's norm is below 1 and whose
  full norm is above is clipped by the full norm; a NaN in one model rank's
  block makes every rank skip; a 2 x 2 checkpoint is the 1-rank file (its
  keys, shapes and dtypes; restored and saved again without a step, the same
  tensors) and restores into one process, and a 1-process checkpoint into the
  grid;
- ``vae_main`` in 2 processes with ``--num_model_shards 2`` (4 steps, an eval
  and a checkpoint at step 2) against the 1-process run.

The children run in processes of their own, one torch thread each, with a
time limit (tests/test_torch_parallel.py's rules). The slice against the JAX
package's sharded step is tests/test_torch_tensor_parallel_jax.py.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from split_vae_torch.core import checkpoint as ckpt  # noqa: E402
from split_vae_torch.core.config import parse_vae_args  # noqa: E402
from split_vae_torch.core.state import create_train_state, tree_tensors  # noqa: E402
from split_vae_torch.parallel import mesh as mesh_mod  # noqa: E402
from split_vae_torch.parallel.mesh import Mesh, rows  # noqa: E402
from split_vae_torch.parallel.tensor import all_gather_cat  # noqa: E402
from split_vae_torch.train import optim  # noqa: E402
from test_torch_parallel import (  # noqa: E402
    B,
    CHILD_TIMEOUT,
    CLI_ARGV,
    SPAIR_B,
    SPAIR_HW,
    VAE_CONFIGS,
    VAE_HW,
    free_port,
    hold_checkpoints,
    hold_params_by_gradient,
    hold_records,
    records,
    recording,
    spair_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}  # data x model
MIN_SIZE = 256  # shards the small models' larger Dense and Conv weights
KINDS = ("lgvae", "lggmvae", "lg_spair")


def spawn_grid(grid, jobs, out_dir, cwd, module="test_torch_tensor_parallel"):
    """Starts ``module.child(rank, ...)`` in num_data x num_model processes;
    returns a function that waits for them (a failed or late rank fails) and
    loads each rank's {job: result}."""
    num_data, num_model = grid
    world = num_data * num_model
    port = free_port()
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import {} as t; "
            "t.child({{}}, {}, {}, {}, {!r}, {!r})").format(REPO, HERE, module, world, num_model,
                                                             port, out_dir, ",".join(jobs))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", code.format(r)], cwd=cwd, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def wait():
        logs = []
        try:
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
                for r in range(world)]

    return wait


def child(rank, world, num_model, port, out_dir, jobs) -> None:
    """A rank's body: the CLI job (it joins the group through its flags), then
    the gloo group of the grid, the jobs, {job: result} to ``rank<r>.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    results = {}
    jobs = jobs.split(",")
    if "cli" in jobs:
        results["cli"] = cli_job(rank, world, port)
    mesh_mod.maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = mesh_mod.create_mesh(num_model=num_model, device="cpu")
    assert (mesh.data_rank, mesh.model_rank) == divmod(rank, num_model), mesh
    assert (mesh.data_size, mesh.model_size) == (world // num_model, num_model), mesh
    for job in jobs:
        if job != "cli":
            results[job] = JOBS[job](mesh, out_dir)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------- train steps

def build(kind: str, mesh: Mesh, seed: int, names_min_size=MIN_SIZE):
    """The model, optimizer (with the model group's reductions), batch and
    train step of ``kind`` at tests/test_torch_parallel.py's shapes; the
    sharded names."""
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.loop import build_vae_model
    from split_vae_torch.train.steps import make_spair_train_step, make_vae_train_step

    if kind == "lg_spair":
        cfg = spair_config()
        model = get_spair_model(cfg.replace(seed=seed), device="cpu")
        batch = np.random.RandomState(0).uniform(0, 1, (SPAIR_B, SPAIR_HW, SPAIR_HW, 3))
        batch = torch.from_numpy(batch.astype(np.float32))
        step = make_spair_train_step(cfg, mesh=mesh)
        tx = optim.spair_optimizer
    else:
        cfg = VAE_CONFIGS[kind]
        model, _ = build_vae_model(cfg.replace(seed=seed), VAE_HW, device="cpu")
        batch = np.random.RandomState(0).randint(0, 255, (B, *VAE_HW, 3)).astype(np.uint8)
        batch = torch.from_numpy(batch)
        step = make_vae_train_step(cfg, mesh)
        tx = optim.vae_optimizer if kind == "lgvae" else optim.gm_optimizer
    names = mesh_mod.infer_param_sharding(model, mesh, names_min_size)
    return model, tx(cfg.learning_rate, mesh_mod.model_reduce(mesh, model, names)), batch, step, names


def gathered_grads(grads, model, names):
    """The 1-rank gradients from this rank's: each sharded one all-gathered."""
    shards = {n: mesh_mod._owner(model, n).shard for n in names}
    order = [n for n, _ in model.named_parameters()]
    return [all_gather_cat(g, shards[n], 0) if n in shards else g for n, g in zip(order, grads)]


def run_step(kind: str, mesh: Mesh, out_dir=None):
    """One train step of ``kind`` on this rank's rows; the model and generator
    from seed + rank, then rank 0's state, then this rank's blocks. Returns the
    loss, the gathered gradients and parameters, and this rank's blocks."""
    seen = []
    seed = 3 + mesh.rank
    model, tx, batch, step, names = build(kind, mesh, seed)
    state = create_train_state(model, recording(tx, seen), seed=seed)
    mesh_mod.broadcast_state_(state, mesh)
    mesh_mod.shard_state(state, mesh, names)
    state, metrics = step(state, batch[rows(mesh, batch.shape[0])])
    full = mesh_mod.gather_state_dict(model)
    return {"loss": float(metrics["total_loss"]), "notfinite": float(metrics["notfinite_updates"]),
            "params": [full[n].clone() for n, _ in model.named_parameters()],
            "grads": gathered_grads(seen[0], model, names), "step": state.step, "names": names,
            "blocks": [p.detach().clone() for p in model.parameters()]}


def one_rank_step(kind: str):
    """The 1-rank step of ``kind``, as ``run_step`` builds it."""
    seen = []
    model, tx, batch, step, _ = build(kind, Mesh(), 3)
    state = create_train_state(model, recording(tx, seen), seed=3)
    state, metrics = step(state, batch)
    return {"loss": float(metrics["total_loss"]), "grads": seen[0], "step": state.step,
            "params": [p.detach().clone() for p in model.parameters()]}


# ---------------------------------------------------------------- the traps

def clip_job(mesh: Mesh, out_dir=None):
    """The clip of a 2-row gradient of which each of 2 model ranks holds one
    row of norm 0.8 (full norm 1.131...), beside a whole one of norm 0.8."""
    reduce = mesh_mod.model_reduce(mesh, _TwoRows(), ["a"])
    clip = optim.clip_by_per_tensor_norm(1.0, reduce)
    block = torch.tensor([[0.8, 0.0]]) if mesh.model_rank == 0 else torch.tensor([[0.0, 0.8]])
    whole = torch.tensor([0.8, 0.0])
    return clip.update([block, whole], ())[0]


class _TwoRows(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Parameter(torch.zeros(2, 2))
        self.b = torch.nn.Parameter(torch.zeros(2))


def nan_job(mesh: Mesh, out_dir=None):
    """A LG-SPAIR step whose first sharded weight's reduced gradient holds a
    NaN in model rank 1's block alone (the data group's mean spreads a NaN
    over every data index): every rank skips."""
    seed = 3
    model, tx, batch, step, names = build("lg_spair", mesh, seed)
    first = [n for n, _ in model.named_parameters()].index(names[0])

    def poison(grads, state):
        if mesh.model_rank == 1:
            grads = list(grads)
            grads[first] = grads[first].clone()
            grads[first] = grads[first].contiguous()
            grads[first].view(-1)[0] = float("nan")
        return tx.update(grads, state)

    state = create_train_state(model, optim.GradientTransformation(tx.init, poison), seed=seed)
    mesh_mod.shard_state(state, mesh, names)
    before = [p.detach().clone() for p in model.parameters()]
    state, metrics = step(state, batch[rows(mesh, batch.shape[0])])
    inner = state.opt_state.inner_state[1]
    return {"notfinite": int(metrics["notfinite_updates"]), "count": int(inner.count),
            "unchanged": all(torch.equal(a, b) for a, b in zip(before, model.parameters()))}


def ckpt_job(mesh: Mesh, out_dir: str):
    """Restores the 1-process checkpoint ``one/checkpoint_1.pt`` into the grid,
    saves it again without a step (``again/``), takes one step and saves
    (``grid/``)."""
    model, tx, batch, step, names = build("lg_spair", mesh, 3)
    state = create_train_state(model, tx, seed=3)
    ckpt.restore_checkpoint(os.path.join(out_dir, "one", "checkpoint_1.pt"), state)
    mesh_mod.broadcast_state_(state, mesh)
    mesh_mod.shard_state(state, mesh, names)
    written = [ckpt.save_checkpoint(os.path.join(out_dir, "again"), state, mesh=mesh)]
    state, _ = step(state, batch[rows(mesh, batch.shape[0])])
    written.append(ckpt.save_checkpoint(os.path.join(out_dir, "grid"), state, mesh=mesh))
    return written


def replay_job(mesh: Mesh, out_dir: str):
    """tests/test_torch_tensor_parallel_jax.py's rank: the LG-SPAIR step on the converted parameters with the
    JAX package's draws replayed at the global shape, render noise 0, the
    weights sharded at MIN_SIZE; the gathered parameters and gradients."""
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.train.steps import make_spair_train_step

    inputs = torch.load(os.path.join(out_dir, "jax_inputs.pt"), weights_only=False)
    cfg = spair_config()
    model = get_spair_model(cfg, device="cpu")
    model.load_state_dict(inputs["params"])
    model.render_noise_scale = 0.0
    names = mesh_mod.infer_param_sharding(model, mesh, MIN_SIZE)
    seen = []
    tx = recording(optim.spair_optimizer(cfg.learning_rate, mesh_mod.model_reduce(mesh, model, names)),
                   seen)
    state = create_train_state(model, tx, seed=0)
    mesh_mod.shard_state(state, mesh, names)
    x = inputs["x"]
    state, metrics = make_spair_train_step(cfg, mesh=mesh)(state, x[rows(mesh, x.shape[0])],
                                                            inputs["replay"])
    order = [n for n, _ in model.named_parameters()]
    return {"loss": float(metrics["total_loss"]), "step": state.step, "names": names,
            "params": {k: v.clone() for k, v in mesh_mod.gather_state_dict(model).items()},
            "grads": dict(zip(order, gathered_grads(seen[0], model, names)))}


def resize_conv_cases():
    """(name, whole layer, x, cotangent) from seed 0: the 3x3 phase form on a
    non-square input and the 6x6 dilated form, each at exactly 2x."""
    from split_vae_torch.nn.common import init_params
    from split_vae_torch.nn.pixel_shuffle import Resize2xConv, Resize2xConvAny

    gen = torch.Generator().manual_seed(0)
    cases = []
    for name, layer, hw in (("3x3", Resize2xConv(6, 8, (10, 12)), (5, 6)),
                            ("6x6", Resize2xConvAny(6, 4, (6, 6), (8, 8)), (4, 4))):
        init_params(layer, gen)
        with torch.no_grad():
            layer.bias.normal_(generator=gen)
        x = torch.randn(2, *hw, 6, generator=gen)
        cot = torch.randn(2, 2 * hw[0], 2 * hw[1], layer.bias.shape[0], generator=gen)
        cases.append((name, layer, x, cot))
    return cases


def resize_conv_grads(layer, x, cot):
    """The layer's output and the gradients of x, its weight and its bias."""
    x = x.clone().requires_grad_()
    out = layer(x)
    return out.detach(), torch.autograd.grad((out * cot).sum(), [x, layer.weight, layer.bias])


def resize_conv_job(mesh: Mesh, out_dir=None):
    """Each fused layer sharded over the model group (this rank's block of
    output channels, every rank the same input): its output and gradients,
    the weight's gathered."""
    from split_vae_torch.parallel.tensor import ModelShard

    results = {}
    for name, layer, x, cot in resize_conv_cases():
        shard = ModelShard(mesh.model_group, mesh.model_rank, mesh.model_size)
        layer.weight = torch.nn.Parameter(shard.block(layer.weight).clone())
        layer.shard = shard
        out, (gx, gw, gb) = resize_conv_grads(layer, x, cot)
        results[name] = {"out": out, "grads": [gx, all_gather_cat(gw, shard, 0), gb]}
    return results


JOBS = {kind: functools.partial(run_step, kind) for kind in KINDS}
JOBS.update(clip=clip_job, nan=nan_job, ckpt=ckpt_job, jax_replay=replay_job,
            resize_conv=resize_conv_job)


# ---------------------------------------------------------------- the CLI

TP_FLAGS = ["--num_model_shards", "2"]


def cli_job(rank, world, port):
    """vae_main with --num_model_shards 2 in this rank; returns the run dirs."""
    from split_vae_torch.cli import vae_main

    import torch.distributed as dist

    vae_main.main(CLI_ARGV + TP_FLAGS + ["--coordinator", f"127.0.0.1:{port}",
                                         "--num_processes", str(world),
                                         "--process_id", str(rank)])
    dist.barrier()  # rank 0 has written its last file
    return sorted(os.listdir("output"))


# ---------------------------------------------------------------- the runs

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both grids' children, and meanwhile the 1-rank references in this
    process: the steps, a 1-process checkpoint for the grid to restore (made
    first), the 1-process step from it, and vae_main's 1-process run."""
    from split_vae_torch.train import loop

    out = {g: str(tmp_path_factory.mktemp(g)) for g in GRIDS}
    cwd2, cwd1 = (str(tmp_path_factory.mktemp(n)) for n in ("cli2", "cli1"))
    threads, home = torch.get_num_threads(), os.getcwd()
    torch.set_num_threads(1)
    try:
        model, tx, batch, step, _ = build("lg_spair", Mesh(), 3)
        state = create_train_state(model, tx, seed=3)
        state, _ = step(state, batch)
        ckpt.save_checkpoint(os.path.join(out["2x2"], "one"), state)
        waits = {"1x2": spawn_grid(GRIDS["1x2"],
                                   ["cli"] + list(KINDS) + ["clip", "nan", "resize_conv"],
                                   out["1x2"], cwd2),
                 "2x2": spawn_grid(GRIDS["2x2"], list(KINDS) + ["nan", "ckpt"], out["2x2"],
                                   out["2x2"])}
        one = {kind: one_rank_step(kind) for kind in KINDS}
        one["resize_conv"] = {name: resize_conv_grads(layer, x, cot)
                              for name, layer, x, cot in resize_conv_cases()}
        state, _ = step(state, batch)  # the grid's step from the checkpoint, in one process
        one["ckpt"] = [p.detach().clone() for p in model.parameters()]
        os.chdir(cwd1)
        _, run1 = loop.train_vae(parse_vae_args(CLI_ARGV))
        results = {g: wait() for g, wait in waits.items()}
    finally:
        os.chdir(home)
        torch.set_num_threads(threads)
    return results, one, out, cwd2, os.path.join(cwd1, run1)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("kind", KINDS)
def test_grid_step_equals_one_rank_step(runs, kind, grid):
    results, one = runs[0][grid], runs[1][kind]
    num_data, num_model = GRIDS[grid]
    many = [r[kind] for r in results]
    assert len(many[0]["names"]) >= 3 and all(m["names"] == many[0]["names"] for m in many)
    assert [m["step"] for m in many] == [1] * len(many) and one["step"] == 1
    assert all(m["notfinite"] == 0 for m in many)
    losses = [m["loss"] for m in many]
    for d in range(num_data):  # a model group's ranks compute one loss
        assert len(set(losses[d * num_model:(d + 1) * num_model])) == 1
    np.testing.assert_allclose(np.mean(losses), one["loss"], rtol=1e-4)
    for m in range(num_model):  # the ranks of a model index hold bit-equal blocks
        for a, b in zip(many[m]["blocks"], many[-num_model + m]["blocks"]):
            assert torch.equal(a, b)
    for other in many[1:]:  # ... and every rank the same gathered parameters
        for a, b in zip(many[0]["params"], other["params"]):
            assert torch.equal(a, b)
    for i, (g1, gn) in enumerate(zip(one["grads"], many[0]["grads"])):
        np.testing.assert_allclose(gn.numpy(), g1.numpy(), rtol=1e-3,
                                   atol=1e-6 * g1.abs().max().item(), err_msg=f"gradient {i}")
    hold_params_by_gradient(one, many[0])


def test_sharded_layers_are_dense_and_conv(runs):
    from split_vae_torch.models.spair import get_spair_model
    from split_vae_torch.nn.common import Conv, Dense

    model = get_spair_model(spair_config(), device="cpu")
    names = runs[0]["2x2"][0]["lg_spair"]["names"]
    owners = [mesh_mod._owner(model, n) for n in names]
    assert any(isinstance(m, Dense) for m in owners) and any(isinstance(m, Conv) for m in owners)
    assert all(isinstance(m, (Dense, Conv)) for m in owners)
    assert all(n.endswith(".weight") for n in names)


@pytest.mark.parametrize("name", ["3x3", "6x6"])
def test_sharded_fused_layer_equals_the_whole_layer(runs, name):
    """A sharded Resize2xConv (Resize2xConvAny) over 2 model ranks: the
    output, the input's gradient (summed over the group), the gathered
    weight's and the bias's gradients are the whole layer's."""
    out, grads = runs[1]["resize_conv"][name]
    for res in runs[0]["1x2"]:
        got = res["resize_conv"][name]
        torch.testing.assert_close(got["out"], out, rtol=1e-5, atol=1e-6)
        for i, (g, w) in enumerate(zip(got["grads"], grads)):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * w.abs().max().item(),
                                       msg=f"gradient {i}")


def test_clip_takes_the_full_norm(runs):
    full = float(np.hypot(0.8, 0.8))
    for r, res in enumerate(runs[0]["1x2"]):
        block, whole = res["clip"]
        want = torch.tensor([[0.8, 0.0]] if r == 0 else [[0.0, 0.8]]) / full
        torch.testing.assert_close(block, want, rtol=1e-6, atol=0)
        assert torch.equal(whole, torch.tensor([0.8, 0.0]))  # norm 0.8: not clipped


@pytest.mark.parametrize("grid", list(GRIDS))
def test_nan_in_one_block_skips_every_rank(runs, grid):
    for res in runs[0][grid]:
        assert res["nan"] == {"notfinite": 1, "count": 0, "unchanged": True}


def test_grid_checkpoint_is_the_one_rank_file(runs):
    results, one, out = runs[0]["2x2"], runs[1], runs[2]["2x2"]
    assert [r["ckpt"][0] is not None for r in results] == [True, False, False, False]
    first = torch.load(os.path.join(out, "one", "checkpoint_1.pt"), weights_only=True)
    again = torch.load(results[0]["ckpt"][0], weights_only=True)
    grid = torch.load(results[0]["ckpt"][1], weights_only=True)
    assert again["step"] == 1 and grid["step"] == 2
    for saved in (again, grid):
        assert list(saved["model"]) == list(first["model"])
        assert [(v.shape, v.dtype) for v in saved["model"].values()] == \
            [(v.shape, v.dtype) for v in first["model"].values()]
        assert [(v.shape, v.dtype) for v in saved["opt_state"]] == \
            [(v.shape, v.dtype) for v in first["opt_state"]]
    for k, v in first["model"].items():  # cut into blocks and gathered again: the same
        assert torch.equal(again["model"][k], v), k
    for a, b in zip(again["opt_state"], first["opt_state"]):
        assert torch.equal(a, b)
    # The grid's step from the 1-process checkpoint restores into one process,
    # where it is the 1-process step from that checkpoint at Adam's rule.
    model, tx, _, _, _ = build("lg_spair", Mesh(), 0)
    state = ckpt.restore_checkpoint(results[0]["ckpt"][1], create_train_state(model, tx))
    assert state.step == 2 and len(tree_tensors(state.opt_state)) == len(grid["opt_state"])
    for i, (got, want) in enumerate(zip(model.parameters(), one["ckpt"])):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=0, atol=2e-4,
                                   err_msg=f"parameter {i}")


def test_vae_main_tensor_parallel_equals_one_process(runs):
    results, _, _, cwd2, run1 = runs
    dirs = [r["cli"] for r in results["1x2"]]
    assert dirs[0] == dirs[1] and len(dirs[0]) == 1
    run2 = os.path.join(cwd2, "output", dirs[0][0])
    hold_records(records(run2), records(run1))
    for step in (2, 4):  # the 1-rank file, at test_torch_parallel.py's tolerances
        hold_checkpoints(os.path.join(run2, "checkpoints", f"checkpoint_{step}.pt"),
                         os.path.join(run1, "checkpoints", f"checkpoint_{step}.pt"), step)
    weights = torch.load(os.path.join(cwd2, "models", dirs[0][0] + ".pt"), weights_only=True)
    want = torch.load(os.path.join(run1, "checkpoints", "checkpoint_4.pt"), weights_only=True)
    assert {k: v.shape for k, v in weights.items()} == {k: v.shape for k, v in want["model"].items()}


# ---------------------------------------------------------------- in one process

def test_create_mesh_refuses_a_grid_that_is_not_the_world(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        mesh_mod.create_mesh(num_model=2)
    with pytest.raises(ValueError, match="num_data_shards x num_model_shards"):
        mesh_mod.create_mesh(num_data=2, num_model=1)
    assert mesh_mod.create_mesh(num_data=1, num_model=1, device="cpu").model_size == 1


def test_rows_follow_the_data_index():
    grid = [Mesh(rank=r, world=4, model_size=2) for r in range(4)]
    assert [(m.data_rank, m.model_rank) for m in grid] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [rows(m, 8) for m in grid] == [slice(0, 4), slice(0, 4), slice(4, 8), slice(4, 8)]
    with pytest.raises(ValueError, match="divide evenly over 2"):
        rows(grid[0], 5)


@pytest.mark.parametrize("tx", ["spair", "amsgrad"])
def test_moments_follow_their_parameter(tx):
    """shard_state cuts each sharded weight and its params-shaped optimizer
    leaves to this rank's block of dim 0; biases, small weights and the
    counts stay whole (tests/test_sharding.py:132-176)."""
    from split_vae_torch.models.spair import get_spair_model

    mesh = Mesh(rank=3, world=4, model_size=2)  # model index 1; no collective is made
    model = get_spair_model(spair_config(), device="cpu")
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    names = mesh_mod.infer_param_sharding(model, mesh, MIN_SIZE)
    chain = (optim.spair_optimizer(1e-4) if tx == "spair"
             else optim.adam(1e-4, amsgrad=True))
    state = create_train_state(model, chain)
    moments = mesh_mod.map_params(state.opt_state, len(whole), lambda i, t: t.fill_(i))
    assert moments is not None
    counts = [t for t in tree_tensors(state.opt_state) if t.dim() == 0]
    mesh_mod.shard_state(state, mesh, names)
    for i, (n, p) in enumerate(model.named_parameters()):
        want = whole[n][whole[n].shape[0] // 2:] if n in names else whole[n]
        assert torch.equal(p, want), n
        got = []
        mesh_mod.map_params(state.opt_state, len(whole), lambda j, t: got.append(t) if j == i else t)
        assert got and all(t.shape == p.shape and bool((t == i).all()) for t in got), n
    assert all(not n.endswith(".bias") for n in names) and len(names) >= 3
    assert [t for t in tree_tensors(state.opt_state) if t.dim() == 0] == counts


def test_one_model_rank_shards_nothing():
    from split_vae_torch.models.spair import get_spair_model

    model = get_spair_model(spair_config(), device="cpu")
    assert mesh_mod.infer_param_sharding(model, Mesh(), min_size=1) == []
    assert mesh_mod.model_reduce(Mesh(), model, []) is None
    state = create_train_state(model, optim.spair_optimizer(1e-4))
    before = [p for p in model.parameters()]
    mesh_mod.shard_state(state, Mesh())
    assert all(a is b for a, b in zip(before, model.parameters()))
