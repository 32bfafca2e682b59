"""Training loops for the VAE and SPAIR workloads (split_vae_tpu/train/loop.py).

The reference trainers' orchestration (vae/trainer.py:72-421,
spair/trainer.py:112-424) on the JAX loop's schedule: ``while step <=
total_steps`` (so a run takes ``training_steps + 1`` steps); the mean loss
printed every ``log_every`` steps; the ``train/`` record (with
``imgs_per_sec``) and a full test sweep at every ``eval_interval`` and at
``total_steps``; a full-state checkpoint at every ``checkpoint_interval`` and
at ``total_steps``; the final weights at ``models/<run>.pt`` relative to the
working directory. ``--resume`` restores a checkpoint; the data order then
starts again from the seed, as in the JAX loop. ``--profile_dir`` traces
step 100 (in both loops; the JAX package traces only the VAE loop).

A labelled ``svhn*`` VAE run loads (or trains) the frozen probe classifier,
logs its test accuracy under ``meta/``, and adds the probe accuracies
(LGVae, LGGMVae) and the cluster accuracy (LGGMVae, GMVae) to every test
sweep, as the JAX loop does.

Every eval also writes the JAX loop's PNG artifacts into the run directory
(``viz/``), under its filenames, inside the JAX loop's ``try`` (a figure
that fails prints ``[viz] skipped: ...`` and never stops training); their
draws come from the eval generator, after the test sweep's. The step timer
restarts after them, so ``train/imgs_per_sec`` leaves them out.
``--compute_dtype bfloat16`` builds every Dense and Conv in bfloat16 (the
parameters stay float32). The step's metrics stay on the device until an
interval's ``result()``.

Data and tensor parallelism, one process a GPU (``parallel/mesh.py``):
``--coordinator`` with ``--num_processes`` and ``--process_id``, or torchrun's
environment; the ranks form a grid of ``--num_data_shards`` (0: all that
remain) x ``--num_model_shards``. ``--batch_size`` is the global batch; every
data index takes its rows of it, and the run takes the 1-rank run's steps.
Every rank builds the whole model, restores ``--resume``, takes rank 0's
state and then keeps its blocks of the sharded weights (``shard_state``).
Rank 0 makes the run directory (its name goes to the others), writes the
records, the checkpoints and the final weights, and runs the test sweeps, the
probe classifier and the PNGs; the other ranks wait at a barrier after each
eval and each checkpoint. With sharded weights the evals run on a whole
replica of the model on rank 0, refreshed from the blocks before each eval
(``_EvalModel``), and the checkpoints hold the 1-rank tensors: both gather
over rank 0's model group, whose ranks join those gathers.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from split_vae_torch.core import checkpoint as ckpt
from split_vae_torch.core.logging import RunLogger, StepTimer, make_run_dir, maybe_profile
from split_vae_torch.core.metrics import MeanMetrics, linear_assignment
from split_vae_torch.core.noise import Noise
from split_vae_torch.core.runtime import setup_runtime
from split_vae_torch.core.state import TrainState, create_train_state
from split_vae_torch.data import get_vae_dataset
from split_vae_torch.data.loader import (
    DEVICE_RESIDENT_MAX_BYTES,
    ArrayDataset,
    device_prefetch,
    device_resident_batches,
    iterate_batches,
    to_device,
)
from split_vae_torch.data.multicub import get_multicub
from split_vae_torch.models.spair import LGGlimpseSPAIR, LGSPAIR, get_spair_model
from split_vae_torch.models.vae import GMVae, LGGMVae, get_vae_model
from split_vae_torch.parallel.mesh import (
    Mesh,
    barrier,
    broadcast_object,
    broadcast_state_,
    create_mesh,
    gather_state_dict,
    infer_param_sharding,
    is_main,
    local_rank,
    maybe_initialize_distributed,
    model_reduce,
    rows,
    shard_state,
)
from split_vae_torch.train import probes as probes_mod
from split_vae_torch.train.optim import (
    GradientTransformation,
    gm_optimizer,
    spair_optimizer,
    vae_optimizer,
)
from split_vae_torch.train.steps import (
    make_spair_eval_step,
    make_spair_train_step,
    make_vae_eval_step,
    make_vae_train_step,
)
from split_vae_torch.viz import artifacts as viz
from split_vae_torch.viz import spair_artifacts as sviz


def build_vae_model(config, image_hw, device="cuda",
                    mesh: Mesh = Mesh()) -> Tuple[torch.nn.Module, GradientTransformation]:
    """The model and its optimizer: Adam for LGVae, Adam with the staircase
    decay for the GM families, each skipping non-finite updates; on a mesh
    with a model group, the optimizer of ``infer_param_sharding``'s shards."""
    if config.model == "lgvae":
        optimizer = vae_optimizer
    elif config.model in ("lggmvae", "gmvae"):
        optimizer = gm_optimizer
    else:
        raise NotImplementedError(config.model)
    model = get_vae_model(config, image_hw, device=device)
    return model, optimizer(config.learning_rate,
                            model_reduce(mesh, model, infer_param_sharding(model, mesh)))


def _train_iterator(train_ds: ArrayDataset, config, mesh: Mesh):
    """This rank's batches (split_vae_tpu/train/loop.py:68-96): the dataset
    resident on the device when it fits under DEVICE_RESIDENT_MAX_BYTES (no
    host-device copy a step; each rank gathers its data index's rows of the
    global batch), else host batches streamed with prefetch, each data index
    from its own disjoint slice of the data when there are several (the JAX
    package's pod path); ``-host_data`` forces the streaming path."""
    mine = rows(mesh, config.batch_size)  # raises unless the ranks' shares are equal
    nbytes = train_ds.images.nbytes + (
        train_ds.labels.nbytes if train_ds.labels is not None else 0)
    if not config.host_data and nbytes <= DEVICE_RESIDENT_MAX_BYTES:
        return device_resident_batches(train_ds, config.batch_size, repeat=True,
                                       seed=config.seed, device=mesh.device, rows=mine)
    return device_prefetch(
        iterate_batches(train_ds, config.batch_size // mesh.data_size, repeat=True,
                        seed=config.seed, process_index=mesh.data_rank,
                        process_count=mesh.data_size),
        device=mesh.device)


def _start(config) -> Mesh:
    """The device, the process group (before any collective) and this
    process's mesh; the debug mode."""
    device = setup_runtime(config.platform, local_rank(config.process_id))
    maybe_initialize_distributed(config.coordinator, config.num_processes, config.process_id,
                                 backend="nccl" if device.type == "cuda" else "gloo")
    mesh = create_mesh(config.num_data_shards, config.num_model_shards, device)
    if mesh.world > 1:
        print(f"Rank {mesh.rank} of {mesh.world} ({mesh.backend}) on {device}: data index "
              f"{mesh.data_rank} of {mesh.data_size}, model index {mesh.model_rank} of "
              f"{mesh.model_size}")
    if config.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    return mesh


def _run_dir(config, mesh: Mesh) -> str:
    """Made by rank 0 alone (names have second resolution), its name sent to
    the other ranks."""
    run_dir = broadcast_object(make_run_dir(config.output_dir) if is_main(mesh) else None, mesh)
    if is_main(mesh):
        print(f"Run dir: {run_dir}")
    return run_dir


def _rank0_first(load, mesh: Mesh):
    """``load()`` on rank 0, then on the others: a dataset's first load may
    write its cache (MultiCUB's .npz), which the other ranks then read."""
    data = load() if is_main(mesh) else None
    barrier(mesh)
    return data if is_main(mesh) else load()


def _resume(config, state: TrainState, mesh: Mesh) -> None:
    """Every rank restores ``--resume``; then every rank holds rank 0's state
    (also without a resume: the ranks' models are built alike, and this makes
    sure of it); then every rank keeps its blocks of the sharded weights."""
    if config.resume:
        ckpt.restore_checkpoint(config.resume, state)
        if is_main(mesh):
            print(f"Resumed from {config.resume} at step {state.step}")
    broadcast_state_(state, mesh)
    names = infer_param_sharding(state.model, mesh)
    shard_state(state, mesh, names)
    if names and is_main(mesh):
        print(f"Tensor parallelism over {mesh.model_size} ranks: {len(names)} weights sharded, "
              f"{sum(p.numel() for p in state.params):,} parameters a rank")


class _EvalModel:
    """The model the evals, the probe and the PNGs run on, on rank 0 alone:
    the trained model itself, or, when its weights are sharded, a whole
    replica (a forward through a sharded layer on rank 0 alone would wait in
    its first gather for the rest of the model group). ``sync`` copies the
    gathered weights into the replica: a collective of rank 0's model group,
    which every rank of it calls before each eval."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh):
        self.mesh = mesh
        self.replica = mesh.model_size > 1
        self.model = copy.deepcopy(model) if self.replica and is_main(mesh) else model

    def sync(self, state: TrainState) -> None:
        if not self.replica or self.mesh.data_rank != 0:
            return
        weights = gather_state_dict(state.model)
        if is_main(self.mesh):
            self.model.load_state_dict(weights)


def _train(config, state: TrainState, train_step, train_iter, evaluate, run_dir: str,
           max_steps: Optional[int], mesh: Mesh, eval_model: _EvalModel,
           meta: Optional[Dict[str, float]] = None) -> TrainState:
    """The JAX loop's schedule around ``train_step``; ``evaluate(step, logger,
    batch)`` runs the test sweeps and the PNGs (``batch`` is the last train
    batch) on ``eval_model``, on rank 0 alone; ``meta`` is logged first,
    under ``meta/``. ``--profile_dir`` traces step 100 (rank 0's)."""
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    main = is_main(mesh)
    train_metrics = MeanMetrics(mesh)
    timer = StepTimer()
    total_steps = min(config.training_steps, max_steps or config.training_steps)
    logger = RunLogger(run_dir) if main else None
    try:
        step = state.step
        if meta and main:
            logger.log(step, meta, prefix="meta/")
        while step <= total_steps:
            batch = next(train_iter)
            with maybe_profile(config.profile_dir if step == 100 and main else None, step):
                state, m = train_step(state, batch)
            train_metrics.update(m)
            timer.add(config.batch_size)  # the global batch
            step += 1

            eval_now = bool(config.eval_interval and step % config.eval_interval == 0)
            if config.log_every and step % config.log_every == 0 and not eval_now:
                r = train_metrics.result()
                if main:
                    print(f"[step {step}] total_loss: {r.get('total_loss', float('nan')):.4f}")
            if eval_now or step == total_steps:
                rate = timer.rate(sync_value=m["total_loss"])
                tm = train_metrics.result()
                tm["imgs_per_sec"] = rate
                train_metrics.reset()
                eval_model.sync(state)
                if main:
                    logger.log(step, tm, prefix="train/")
                    evaluate(step, logger, batch)
                barrier(mesh)
                timer.reset()
            if (config.checkpoint_interval and step % config.checkpoint_interval == 0) \
                    or step == total_steps:
                if mesh.data_rank == 0:  # rank 0's model group gathers, rank 0 writes
                    ckpt.save_checkpoint(ckpt_dir, state, mesh=mesh)
                barrier(mesh)

        if mesh.data_rank == 0:
            ckpt.save_weights(os.path.join("models", os.path.basename(run_dir) + ".pt"),
                              state.model, mesh)
    finally:
        if logger is not None:
            logger.close()
    print("Training done!")
    return state


def train_vae(config, max_steps: Optional[int] = None):
    """Train LGVae / LGGMVae / GMVae (vae/trainer.py:72-421)."""
    mesh = _start(config)
    device = mesh.device
    run_dir = _run_dir(config, mesh)

    train_ds, test_ds, input_shape = _rank0_first(lambda: get_vae_dataset(config), mesh)
    h, w = input_shape[1], input_shape[2]
    model, tx = build_vae_model(config, (h, w), device, mesh)
    state = create_train_state(model, tx, seed=config.seed)
    print(f"Model {config.model}: {sum(p.numel() for p in model.parameters()):,} params")
    eval_model = _EvalModel(model, mesh)
    _resume(config, state, mesh)
    model = eval_model.model

    vae_step = make_vae_train_step(config, mesh)
    eval_step = make_vae_eval_step(config, model)
    labeled = train_ds.labels is not None
    eval_gen = torch.Generator(device=device).manual_seed(config.seed + 1)

    # The classifier probe of a labelled SVHN run (vae/trainer.py:81-97), on
    # rank 0, which runs the evals.
    gm = isinstance(model, (LGGMVae, GMVae))
    probe_step = None
    meta = None
    if config.label and config.dataset.lower().startswith("svhn") and is_main(mesh):
        classifier = probes_mod.load_or_train_classifier(config, device=device)
        test_acc = probes_mod.evaluate_classifier(classifier, test_ds)
        print(f"Classifier test acc: {test_acc:.4f}")
        meta = {"classifier_test_acc": float(test_acc)}
        if test_acc < 0.5:
            print("WARNING: probe classifier is near chance on real test "
                  "images; classifier_* probe metrics will be unreliable "
                  "(wrong dataset flavor or undertrained probe).")
        if not isinstance(model, GMVae):
            probe_step = probes_mod.make_vae_probe_step(model, classifier,
                                                        gm=isinstance(model, LGGMVae))

    def train_step(state, batch):
        return vae_step(state, batch[0] if labeled else batch)

    def evaluate(step, logger, batch):
        """The full test sweep (vae/trainer.py:317-349), then the PNGs
        (vae/trainer.py:385-403) of the last test batch."""
        test_metrics = MeanMetrics()
        all_labels, all_pred = [], []
        last_images = None
        for tb in iterate_batches(test_ds, config.batch_size, shuffle=False):
            t_imgs, t_labels = tb if labeled else (tb, None)
            out, m_test, last_images = eval_step(eval_gen, to_device(t_imgs, device))
            test_metrics.update(m_test)
            if t_labels is not None and probe_step is not None:
                test_metrics.update(probe_step(out, to_device(t_labels, device),
                                               Noise(eval_gen)))
            if t_labels is not None and gm:
                all_labels.append(np.asarray(t_labels))
                all_pred.append(out.y_logits.float().cpu().numpy())
        results = test_metrics.result()
        if all_labels:
            labels_cat = np.concatenate(all_labels)
            cluster_pred = linear_assignment(labels_cat, np.concatenate(all_pred))
            results["classifier_cluster_acc"] = float(
                (cluster_pred.argmax(1) == labels_cat.argmax(1)).mean())
        logger.log(step, results, prefix="test/")
        try:
            _vae_visualize(config, model, Noise(eval_gen), last_images, test_ds, run_dir, step)
        except Exception as e:  # a figure never stops training, as in the JAX loop
            print(f"[viz] skipped: {type(e).__name__}: {e}")

    barrier(mesh)
    state = _train(config, state, train_step, _train_iterator(train_ds, config, mesh),
                   evaluate, run_dir, max_steps, mesh, eval_model, meta=meta)
    return state, run_dir


def train_spair(config, max_steps: Optional[int] = None):
    """Train SPAIR / BG-SPAIR / LG-SPAIR / LGGlimpseSPAIR (spair/trainer.py:112-424)."""
    mesh = _start(config)
    device = mesh.device
    run_dir = _run_dir(config, mesh)

    train_ds, test_sets, input_shape, _ = _rank0_first(lambda: get_multicub(config), mesh)
    size, num_channel = input_shape[1], input_shape[3]
    config.image_size = (size, size, num_channel)

    model = get_spair_model(config, device=device)
    # Keras Adam(clipnorm=1.0) clips per tensor, not globally (spair/main.py:109).
    tx = spair_optimizer(config.learning_rate,
                         model_reduce(mesh, model, infer_param_sharding(model, mesh)))
    state = create_train_state(model, tx, seed=config.seed)
    print(f"Model {config.model}: {sum(p.numel() for p in model.parameters()):,} params")
    eval_model = _EvalModel(model, mesh)
    _resume(config, state, mesh)
    model = eval_model.model

    eval_step = make_spair_eval_step(config, model)
    eval_gen = torch.Generator(device=device).manual_seed(config.seed + 1)

    def evaluate(step, logger, batch):
        """The decomposition of the last train batch (spair/trainer.py:331-378),
        then the dual test sweep, seen + unseen backgrounds, each with its
        PNGs of its last batch (spair/trainer.py:381-401)."""
        try:
            _spair_train_plot(eval_step, eval_gen, batch, run_dir, step)
        except Exception as e:  # a figure never stops training, as in the JAX loop
            print(f"[viz] train plot skipped: {type(e).__name__}: {e}")
        for test_num, test_ds_i in enumerate(test_sets):
            test_metrics = MeanMetrics()
            labeled = test_ds_i.labels is not None
            viz_images = None
            for tb in iterate_batches(test_ds_i, config.batch_size, shuffle=False):
                t_imgs, t_labels = tb if labeled else (tb, None)
                _, m_test, viz_images = eval_step(
                    eval_gen, to_device(t_imgs, device),
                    to_device(t_labels, device) if t_labels is not None else None)
                test_metrics.update(m_test)
            logger.log(step, test_metrics.result(), prefix=f"test{test_num}/")
            try:
                _spair_visualize(model, viz_images, Noise(eval_gen), run_dir,
                                 f"_it_{step}_{test_num}")
            except Exception as e:
                print(f"[viz] skipped: {type(e).__name__}: {e}")

    state = _train(config, state, make_spair_train_step(config, mesh=mesh),
                   _train_iterator(train_ds, config, mesh), evaluate, run_dir, max_steps, mesh,
                   eval_model)
    return state, run_dir


def _vae_visualize(config, model, noise: Noise, last_images: Optional[torch.Tensor], test_ds,
                   run_dir: str, step: int) -> None:
    """The VAE eval's PNGs (split_vae_tpu/train/loop.py:248-277): for LGVae
    and LGGMVae (never GMVae) the samples, the recon strips of the last test
    batch, the two vary grids and a style transfer (SVHN's hand-picked digits
    for svhn*, else the CelebA form when the batch holds 20 images); with
    ``--viz`` for LGGMVae the cluster galleries and the three cluster grids."""
    suffix = f"_it_{step}"
    if not isinstance(model, GMVae):
        viz.generate(model, noise, filename=f"generate_it_{step}", filepath=run_dir)
        if last_images is not None:
            viz.reconstruction_test_lg_vae(model, last_images, noise, filename=suffix,
                                           filepath=run_dir)
        for vary in ("lower", "upper"):
            viz.generate_varying_latent(model, noise, vary, filename=f"vary_{vary}_it_{step}",
                                        filepath=run_dir)
        if config.dataset.lower().startswith("svhn"):
            viz.style_transfer_test(model, test_ds.images, noise, filename=suffix,
                                    filepath=run_dir)
        elif last_images is not None and last_images.shape[0] >= 20:
            viz.style_transfer_celeba(model, last_images, noise, filename=suffix,
                                      filepath=run_dir)
    if config.viz and isinstance(model, LGGMVae):
        if last_images is not None:
            viz.unseen_cluster_lg(model, [last_images], noise, filename=suffix, filepath=run_dir)
        for vary, name in (("zg", "generate_cluster_fix_zl"), ("zg_zl", "generate_cluster"),
                           ("y_zg", "generate_multi_cluster")):
            viz.generate_cluster(model, noise, vary, filename=f"{name}_it_{step}",
                                 filepath=run_dir)


def _spair_train_plot(eval_step, generator: torch.Generator, batch: torch.Tensor, run_dir: str,
                      step: int) -> None:
    """The last train batch forwarded once through the eval step, and its
    decomposition (split_vae_tpu/train/loop.py:345-352)."""
    out, _, images = eval_step(generator, batch)
    sviz.train_decomposition_plot(images, out, filename=str(step), filepath=run_dir)


def _spair_visualize(model, images: torch.Tensor, noise: Noise, run_dir: str,
                     suffix: str) -> None:
    """A SPAIR test set's PNGs of its last batch (split_vae_tpu/train/loop.py:371-387):
    the decomposition, the boxes, the glimpses, then LG-SPAIR's local recon
    or LGGlimpseSPAIR's scrambled glimpses."""
    for writer in (sviz.reconstruction_test, sviz.reconstruction_bbox,
                   sviz.glimpses_reconstruction_test):
        writer(model, images, noise, filename=suffix, filepath=run_dir)
    if isinstance(model, LGSPAIR):
        sviz.x_hat_reconstruction_test(model, images, noise, filename=suffix, filepath=run_dir)
    if isinstance(model, LGGlimpseSPAIR):
        sviz.glimpses_local_reconstruction_test(model, images, noise, filename=suffix,
                                                filepath=run_dir)
