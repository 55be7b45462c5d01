"""The training drivers: phase-1 multi-task pretraining and phase-2 EgoPack
(the port's counterparts of ``egopack_tpu/train/driver.py:train_mtl`` and
``train_egopack`` and the pieces they share).

Reference ``main_temporal.py:137-427`` and ``main_egopack.py:162-464`` on
one card: the four task datasets and loaders, the multi-task system built
from the config, multiloader epochs of ``steps_per_call`` step groups,
per-epoch loss and norm records in ``metrics.jsonl``, validation meters,
optional full-state checkpoints, and at the end the
``<prefix>_<sorted tasks>`` artifact in the JAX package's format. Phase 2
merges a phase-1 artifact, builds the prototype banks from the AR train
set, trains the novel task's head and GraphONE over them, and validates
every epoch.

Randomness comes from one CPU ``torch.Generator`` per run, seeded by
``seed``: the parameters' init seed first (phase 2: then GraphONE's), then
two seeds per epoch (the train steps' dropout, the LTA validation samples),
each for a generator on the run's device. A checkpoint holds that
generator's state, so a resumed run draws what the straight run draws.

Under ``torchrun`` (a world of more than one process, or
``parallel.multihost=True``) every process joins ``torch.distributed``
and takes its place in the ``parallel.data x parallel.model`` grid
(``egopack_torch/parallel``): its loaders build its block of every global
batch, its system holds its parameter shards, validation is sharded and
the meters merged, the prototype sweep is split over the data axis and the
banks by row over the model axis. Every rank runs the same seeds. Rank 0
alone writes the run directory, the checkpoints and the artifacts, which
hold whole tensors, so they load on any grid.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import interop, tracing
from ..config import instantiate, to_container
from ..data.loader import (DeviceCopier, MultiLoader, build_dataloader,
                           close_loaders, device_prefetch)
from ..device import make_generator, resolve_device
from ..eval.meters import build_meter_for_dataset
from ..eval.validate import to_host, validate, validate_lta, validate_pnr
from ..io import native
from ..models.graphone import GraphONE, build_prototypes, make_prototype_step
from ..models.heads import LTATask, OSCCTask, PNRTask, RecognitionTask
from ..parallel import mesh as pmesh
from ..parallel import multihost as mh
from ..parallel.collectives import shard_of
from ..utils import plots
from ..utils.logging import (NullLogger, RunLogger, format_run_name,
                             setup_logging)
from . import optim as topt
from .checkpoint import (latest_state, load_artifact, merge_loaded_params,
                         restore_state, save_artifact, save_state,
                         wait_for_saves)
from .system import CKPT_KEYS, Banks, MultiTaskSystem, TaskSetup

logger = logging.getLogger(__name__)

TASKS = ("ar", "oscc", "lta", "pnr")
TITLES = {"ar": "Recognition", "oscc": "OSCC", "lta": "LTA", "pnr": "PNR"}
# aux-task sets per primary head in phase 2
# (egopack_tpu/train/driver.py:42-47, reference main_egopack.py:268-280)
PHASE2_AUX = {
    "ar": ("oscc", "lta", "pnr"),
    "oscc": ("ar", "lta", "pnr"),
    "lta": ("ar", "oscc", "pnr"),
    "pnr": ("ar", "oscc", "lta"),
}
# the prototype sweep's batch (egopack_tpu/train/driver.py:580-589)
PROTO_BATCH = 256
# the train step's spans (``MultiTaskSystem._make_inner_step``) whose median
# host ms each epoch reports
PHASES = ("step", "forward", "backward", "norms", "optimizer")


def config_device(name: Any) -> torch.device:
    """The config's ``device``: ``tpu``, ``gpu`` and ``cuda`` mean the card
    (the JAX configs say ``tpu``), ``cpu`` the CPU. A card that is missing
    raises; nothing drops to the CPU on its own."""
    s = str(name).lower()
    if s in ("tpu", "gpu", "cuda"):
        return resolve_device("cuda")
    if s == "cpu":
        return resolve_device(s)
    raise ValueError(f"device={name!r}: expected tpu, gpu, cuda or cpu")


def check_supported(cfg) -> None:
    """Note the settings the port takes and ignores."""
    if cfg.get("compilation_cache_dir", None):
        logger.info("compilation_cache_dir=%s is ignored: the port compiles "
                    "no XLA programs", cfg.compilation_cache_dir)


def world_size() -> int:
    """The processes ``torchrun`` started (``WORLD_SIZE``; 1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def setup_mesh(cfg, device: torch.device) -> pmesh.Mesh:
    """Join ``torch.distributed`` when ``parallel.multihost`` is set or the
    world has more than one process (``egopack_tpu/train/driver.py:460``),
    then the ``parallel.data x parallel.model`` grid on this rank's device,
    and the batch's divisibility over its data axis (``:480-481``)."""
    par = cfg.parallel
    if bool(par.get("multihost", False)) or world_size() > 1:
        device = mh.initialize(device)
    mesh = pmesh.make_mesh(int(par.get("data", -1)), int(par.get("model", 1)),
                           device)
    pmesh.check_batch_divisible(cfg.batch_size, mesh)
    return mesh


def artifact_name(cfg, task_weights: Dict[str, float]) -> str:
    """``<prefix>_<sorted enabled tasks>`` (reference main_temporal.py:159)."""
    return f"{cfg.artifact_prefix}_" + "-".join(
        sorted(t for t, w in task_weights.items() if w > 0))


def task_weights_from_cfg(cfg) -> Dict[str, float]:
    return {t: (getattr(cfg, f"weight_{t}") if t in cfg.enabled_tasks else 0)
            for t in TASKS}


def build_datasets(cfg, mesh: Optional[pmesh.Mesh] = None
                   ) -> Dict[str, Dict[str, Any]]:
    """The four task datasets and their loaders (both mains build all four
    whatever ``enabled_tasks`` says, reference main_temporal.py:161-235);
    ``loader_processes > 0`` builds the batches in worker processes, which
    :func:`~egopack_torch.data.loader.close_loaders` stops. On a mesh with
    a data axis, the train and validation loaders build this rank's block
    of every global batch (``egopack_tpu/train/driver.py:73-101``)."""
    out = {}
    dataset_cfgs = {"ar": cfg.dataset_recognition, "oscc": cfg.dataset_oscc,
                    "lta": cfg.dataset_lta, "pnr": cfg.dataset_pnr}
    workers = int(cfg.get("loader_processes", 0))
    shard = mh.process_shard(mesh) if mesh is not None else None
    for name, dcfg in dataset_cfgs.items():
        train = instantiate(dcfg, split="train")
        val = instantiate(dcfg, split=cfg.validation_split)
        out[name] = {
            "train": train, "val": val,
            "dl_train": build_dataloader(train, cfg.batch_size, True,
                                         cfg.num_workers, True, seed=cfg.seed,
                                         worker_processes=workers,
                                         process_shard=shard),
            "dl_val": build_dataloader(val, cfg.batch_size, False,
                                       cfg.num_workers, False, seed=cfg.seed,
                                       worker_processes=workers,
                                       process_shard=shard),
        }
    sizes = {n: d["train"].features_size for n, d in out.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(
            f"Input features should have the same size for all tasks: {sizes}")
    return out


def build_system(cfg, dsets, device: torch.device,
                 phase2: bool = False) -> MultiTaskSystem:
    """The system at the config's widths: ``model.*`` (hidden size, depth,
    pooling), ``oscc_feat_size``, ``task_dropout``, ``task_head_dropout``,
    ``compute_dtype``, ``fused_layout`` (the ``EGOPACK_FUSED_LAYOUT``
    environment variable wins); class counts and graph specs from the
    datasets. ``phase2``: every head carries the aux classifiers of
    :data:`PHASE2_AUX`, and OSCC projects to ``hidden`` and averages its
    logits (egopack_tpu/train/driver.py:116-164). Parameters are zeros
    until ``init_params``."""
    hidden = cfg.model.hidden_size
    backbone = instantiate(cfg.model, _recursive_=False,
                           input_size=dsets["ar"]["train"].features_size,
                           num_segments=cfg.dataset_recognition.num_segments,
                           device=device)
    aux = PHASE2_AUX if phase2 else {t: None for t in TASKS}
    common = dict(input_size=hidden, dropout=cfg.task_dropout,
                  head_dropout=cfg.task_head_dropout, device=device)
    heads = {
        "ar": RecognitionTask(name_="ar", features_size=hidden,
                              heads=dsets["ar"]["train"].num_class_labels,
                              aux_tasks=aux["ar"], **common),
        # phase-1 OSCC projects to oscc_feat_size (main_temporal.py:253),
        # phase-2 to hidden with averaged logits (main_egopack.py:271-272)
        "oscc": OSCCTask(name_="oscc",
                         features_size=hidden if phase2 else cfg.oscc_feat_size,
                         loss_func=cfg.oscc_loss, aux_tasks=aux["oscc"],
                         average_logits=phase2, **common),
        "lta": LTATask(name_="lta", features_size=hidden,
                       heads=dsets["lta"]["train"].num_class_labels,
                       aux_tasks=aux["lta"], **common),
        "pnr": PNRTask(name_="pnr", features_size=hidden, aux_tasks=aux["pnr"],
                       **common),
    }
    weights = task_weights_from_cfg(cfg)
    tasks = {
        name: TaskSetup(name, heads[name],
                        dsets[name]["train"].graph_spec(k=cfg.k),
                        weights[name],
                        append_node=(dsets[name]["train"].append_node
                                     if name == "lta" else None))
        for name in TASKS}
    dtype = (torch.bfloat16
             if str(cfg.get("compute_dtype", "float32")) == "bfloat16"
             else torch.float32)
    layout = (os.environ.get("EGOPACK_FUSED_LAYOUT")
              or cfg.get("fused_layout", None) or "auto")
    return MultiTaskSystem(backbone, tasks, compute_dtype=dtype,
                           fused_layout=layout, device=device)


def merge_flax(system: MultiTaskSystem, tree: Dict[str, Any]) -> None:
    """Load a flax parameter tree into ``system`` with
    ``load_state_dict(strict=False)`` semantics (``merge_loaded_params``):
    the leaves the system names are taken, its own values stay elsewhere."""
    system.load_state(merge_loaded_params(
        system.model.state_dict(),
        {n: v.to(system.device)
         for n, v in interop.from_flax(tree).items()}))


def make_eval_steps(system: MultiTaskSystem, task_weights,
                    aux_tasks: Sequence[str] = (),
                    graphone: Optional[GraphONE] = None,
                    late_fusion: bool = True) -> Dict[str, Callable]:
    """Each task's eval step. With ``graphone`` (phase 2) the active tasks
    interact with the other aux tasks' banks
    (egopack_tpu/train/driver.py:659-665)."""
    steps = {}
    for t in TASKS:
        ego = graphone is not None and task_weights[t] > 0
        steps[t] = system.make_eval_step(
            t, aux=tuple(a for a in aux_tasks if a != t) if ego else (),
            graphone=graphone if ego else None, late_fusion=late_fusion)
    return steps


def make_run_logger(cfg, mesh: Optional[pmesh.Mesh] = None):
    """The run's logger on rank 0; a no-op logger on the other ranks, whose
    records would repeat rank 0's (``egopack_tpu/train/driver.py:167-176``).
    """
    if mesh is not None and mesh.rank != 0:
        return NullLogger()
    return RunLogger(cfg.output_dir,
                     format_run_name(cfg.wandb_name_pattern,
                                     to_container(cfg)),
                     to_container(cfg))


def draw_seed(run_gen: torch.Generator) -> int:
    """The next seed from the run's generator."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=run_gen))


def _run_validation(cfg, system: MultiTaskSystem, dsets, task_weights,
                    epoch: int, run_logger: RunLogger, eval_steps,
                    generator: torch.Generator, banks: Optional[Banks] = None,
                    force_all: bool = False) -> Dict[str, Dict[str, Any]]:
    """The validation block (reference main_temporal.py:345-404,
    egopack_tpu/train/driver.py:204-250): one meter per enabled task, or
    per task with ``force_all``; ``banks`` go to every eval step. On the
    system's mesh each rank meters its block and the meters are merged over
    the data axis. Returns ``{task: meter.get_logs()}``."""
    mesh = system.mesh
    metrics: Dict[str, Dict[str, Any]] = {}
    for name in TASKS:
        if not (force_all or task_weights[name] > 0):
            continue
        meter = build_meter_for_dataset(
            dsets[name]["val"],
            save_features=bool(cfg.get("log_feature_plots", False)),
            log_confusion=bool(cfg.get("log_confusion_matrices", False)))
        step, loader = eval_steps[name], dsets[name]["dl_val"]
        if name == "lta":
            # the one-process run's samples of this rank's block
            validate_lta(step, banks, loader, meter,
                         system.tasks["lta"].head.generate_from_logits,
                         system.sample_generator(generator), system.device,
                         mesh)
        elif name == "pnr":
            validate_pnr(step, banks, loader, meter, system.device, mesh)
        else:
            validate(step, banks, loader, meter, name, system.device, mesh)
        mh.merge_meter(meter, mesh)
        logger.info(" ## %s ## ", TITLES[name])
        for line in meter.print_logs():
            logger.info(line)
        logs = meter.get_logs()
        run_logger.log({f"val/{name}/{k}": v for k, v in logs.items()
                        if isinstance(v, (int, float))}, step=epoch)
        _emit_plots(run_logger, meter, name, epoch)
        metrics[name] = logs
    return metrics


def _emit_plots(run_logger: RunLogger, meter, name: str, epoch: int) -> None:
    """What the reference sends to wandb, as files in the run directory
    (egopack_tpu/train/driver.py:253-282): the top-2 confusion and
    per-class accuracy tables (reference utils/meters/ego4d.py:134-203) as
    JSON with their heatmaps (``utils/plots.py``; skipped with a warning
    without matplotlib), and the t-SNE embeddings of the features
    (reference utils/meters/base.py:36-39) as ``features_<task>_ep<n>.npz``.
    Nothing on ranks without a run directory."""
    if isinstance(run_logger, NullLogger):
        return
    if getattr(meter, "log_confusion", False):
        tables = {which: meter.confusion_tables(which)
                  for which in ("verbs", "nouns")}
        path = osp.join(run_logger.dir, f"confusion_{name}_ep{epoch}.json")
        with open(path, "w") as f:
            json.dump(tables, f)
        logger.info("Wrote confusion tables to %s", path)
        for which in ("verbs", "nouns"):
            png = plots.heatmap_path(run_logger.dir, name, which, epoch)
            if plots.save_confusion_heatmap(meter.confusion(which), png):
                logger.info("Wrote confusion heatmap to %s", png)
    if meter.save_features:
        arrays = {}
        for which in ("pre", "post"):
            emb = meter.feature_embedding(which)
            if emb is not None:
                arrays[which] = emb
        if arrays:
            path = osp.join(run_logger.dir, f"features_{name}_ep{epoch}.npz")
            np.savez(path, **arrays)
            logger.info("Wrote t-SNE feature embeddings to %s", path)


def _epoch_means(logs: List[Dict[str, torch.Tensor]],
                 keys: Sequence[str]) -> Dict[str, float]:
    """Mean of each key's values over the epoch's step logs, fetched to the
    host in one wait (the JAX package's numpy float32 means)."""
    keys = [k for k in keys if any(k in l for l in logs)]
    flat = [torch.cat([l[k].detach().float().reshape(-1) for l in logs
                       if k in l]) for k in keys]
    return {k: float(np.mean(v)) for k, v in zip(keys, to_host(flat))}


class _Profiler:
    """A ``torch.profiler`` Chrome trace of the steps after the first, over
    the window the JAX driver traces (``driver.py:380-408``)."""

    def __init__(self, out_dir: Optional[str], device: torch.device):
        self.out_dir, self.device = out_dir, device
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        path = osp.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof, self.out_dir = None, None
        logger.info("Wrote profiler trace to %s", path)

    def step(self, n_steps: int, spc: int) -> None:
        if self.out_dir and self.prof is None and n_steps >= 1:
            self.start()
        elif self.prof is not None and n_steps >= 1 + max(spc, 4):
            self.stop()


def _emit_histograms(run_logger: RunLogger, hists, epoch: int) -> None:
    """One ``histograms_ep<epoch>.npz`` in the run directory, two arrays a
    parameter: ``<grad_hist|param_hist>/<path>:counts`` (bins,) and
    ``...:edges`` (bins+1,) (egopack_tpu/train/driver.py:287-303).
    Nothing on ranks without a run directory."""
    if isinstance(run_logger, NullLogger):
        return
    keys = list(hists)
    arrays = to_host([t for k in keys for t in hists[k]])
    out = {}
    for i, key in enumerate(keys):
        out[f"{key}:counts"], out[f"{key}:edges"] = arrays[2 * i:2 * i + 2]
    path = osp.join(run_logger.dir, f"histograms_ep{epoch}.npz")
    np.savez(path, **out)
    logger.info("Wrote %d histograms to %s", len(keys), path)


def _maybe_resume(cfg, ckpt_dir: str, system: MultiTaskSystem,
                  opt_state: topt.AdamState,
                  run_gen: torch.Generator) -> int:
    """Restore the newest full-state checkpoint, if checkpoints are on and
    one exists; returns the first epoch to run. The checkpoint holds whole
    tensors; each rank keeps its slice of the split ones."""
    if not cfg.checkpoint.enable:
        return 1
    wait_for_saves()  # a background write of this process may be pending
    last = latest_state(ckpt_dir)
    if last is None:
        return 1
    state = restore_state(ckpt_dir, last, system.device)

    def mine(name: str, full: torch.Tensor) -> torch.Tensor:
        dim = system.shards.get(name)
        return full if dim is None else shard_of(full, system.mesh.model_axis,
                                                 dim)

    with torch.no_grad():
        for n, p in system.params().items():
            p.copy_(mine(n, state["params"][n]))
        for ours, saved in ((opt_state.mu, state["mu"]),
                            (opt_state.nu, state["nu"])):
            for n in ours:
                ours[n].copy_(mine(n, saved[n]))
    opt_state.count = int(state["count"])
    run_gen.set_state(state["generator"])
    logger.info("Resumed full state from epoch %d", last)
    return int(state["epoch"]) + 1


def _save_checkpoint(ckpt_dir: str, epoch: int, system: MultiTaskSystem,
                     opt_state: topt.AdamState, run_gen: torch.Generator,
                     async_write: bool) -> None:
    """The full state, split tensors gathered (every rank calls this), as
    rank 0 writes it."""
    def whole(tree):
        return pmesh.gather_params(tree, system.shards, system.mesh)

    params = whole({n: p.detach() for n, p in system.params().items()})
    mu, nu = whole(opt_state.mu), whole(opt_state.nu)
    if system.mesh.rank != 0:
        return
    save_state(ckpt_dir, epoch, {
        "params": params, "mu": mu, "nu": nu, "count": opt_state.count,
        "generator": run_gen.get_state(), "epoch": epoch},
        async_write=async_write)


def _run_epochs(cfg, *, system: MultiTaskSystem, opt_state, dsets,
                task_weights, active, step_fn: Callable,
                multi_fn: Optional[Callable], lr_fn, run_gen,
                run_logger, eval_steps, ckpt_dir: str, start_epoch: int,
                should_validate: Callable[[int], bool],
                banks: Optional[Banks] = None, force_all: bool = False,
                hist_fn: Optional[Callable] = None):
    """Multiloader epochs with ``steps_per_call`` groups and a one-by-one
    tail, the per-epoch records, checkpoints and validation
    (reference main_temporal.py:300-404, main_egopack.py:316-448). With
    ``banks`` (phase 2) they are the steps' leading extra argument
    (egopack_tpu/train/driver.py:346). The steps' logs stay on the device
    until the epoch's end. Every ``log_histograms_every`` epochs,
    ``hist_fn`` takes a snapshot on the epoch's first batch group with a
    generator seeded as the epoch's steps (JAX: the first step's key,
    egopack_tpu/train/driver.py:433-438). Returns (val_metrics, per-epoch
    stats)."""
    spc = int(cfg.get("steps_per_call", 1))
    hist_every = int(cfg.get("log_histograms_every", 0)) if hist_fn else 0
    device = system.device
    x_dtype = torch.bfloat16 if system.compute_dtype == torch.bfloat16 \
        else None
    copier = DeviceCopier(device, x_dtype)
    # one trace, rank 0's
    profiler = _Profiler(cfg.get("profile_dir", None)
                         if system.mesh.rank == 0 else None, device)
    val_metrics: Dict[str, Any] = {}
    stats = []
    extra = () if banks is None else (banks,)

    def put(tup):
        return {t: copier.put(b) for t, b in zip(TASKS, tup) if t in active}

    for epoch in range(start_epoch, cfg.num_epochs + 1):
        tracing.reset()
        t0 = time.perf_counter()
        step_seed = draw_seed(run_gen)
        generator = make_generator(step_seed, device)
        val_generator = make_generator(draw_seed(run_gen), device)
        for t in TASKS:
            dsets[t]["dl_train"].set_epoch(epoch)
        ml = MultiLoader([dsets[t]["dl_train"] for t in TASKS],
                         [task_weights[t] for t in TASKS])
        lr = lr_fn(epoch - 1)
        logs: List[Dict[str, torch.Tensor]] = []
        pending: list = []
        n_steps = 0
        data_s = 0.0  # the host's wait for each next batch group
        first_batches = None  # kept for the histograms only
        groups = device_prefetch(iter(ml), put, copier.ready)
        while True:
            with tracing.span("egopack.data_wait") as wait:
                batches = next(groups, None)
            data_s += wait.seconds
            if batches is None:
                break
            if hist_every and first_batches is None:
                first_batches = batches
            profiler.step(n_steps, spc)
            if multi_fn is not None:
                pending.append(batches)
                if len(pending) < spc:
                    continue
                logs.append(multi_fn(opt_state, *extra, pending, generator,
                                     lr))
                pending = []
                n_steps += spc
            else:
                logs.append(step_fn(opt_state, *extra, batches, generator,
                                    lr))
                n_steps += 1
        if profiler.prof is not None:  # short epoch: close the trace
            profiler.stop()
        for batches in pending:  # the tail, one step at a time
            logs.append(step_fn(opt_state, *extra, batches, generator, lr))
            n_steps += 1
        norm_keys = sorted({k for l in logs for k in l
                            if k.startswith(("grad_norm", "param_norm"))})
        means = _epoch_means(logs, [f"{t}_loss" for t in active] + norm_keys)
        train_s = time.perf_counter() - t0
        spans = tracing.summary()
        host_ms = {p: spans[f"egopack.{p}"]["median_ms"] for p in PHASES
                   if f"egopack.{p}" in spans}
        h2d_s = spans.get("egopack.h2d", {}).get("total_s", 0.0)
        stats.append({"epoch": epoch, "steps": n_steps, "train_s": train_s,
                      "data_s": data_s, "host_ms": host_ms, "h2d_s": h2d_s})
        losses = {t: means[f"{t}_loss"] for t in active}
        logger.info("Epoch %3d/%d (%d steps, %.1fs, lr %.2e) losses: %s; "
                    "%.2fs waiting for data; host ms a step (median): %s; "
                    "%.3fs in pinned copies", epoch, cfg.num_epochs, n_steps,
                    train_s, lr, {t: round(v, 4) for t, v in losses.items()},
                    data_s, {p: round(v, 2) for p, v in host_ms.items()},
                    h2d_s)
        run_logger.log({**{f"train/{t}/loss": v for t, v in losses.items()},
                        **{f"train/{k}": means[k] for k in norm_keys}},
                       step=epoch)
        if hist_every and epoch % hist_every == 0 \
                and first_batches is not None:
            _emit_histograms(run_logger, hist_fn(
                *extra, first_batches, make_generator(step_seed, device)),
                epoch)
        if cfg.checkpoint.enable and epoch % cfg.checkpoint.every == 0:
            _save_checkpoint(ckpt_dir, epoch, system, opt_state, run_gen,
                             bool(cfg.checkpoint.get("async_write", False)))
        if should_validate(epoch):
            val_metrics = _run_validation(cfg, system, dsets, task_weights,
                                          epoch, run_logger, eval_steps,
                                          val_generator, banks, force_all)
    return val_metrics, stats


def _place(system: MultiTaskSystem, mesh: pmesh.Mesh) -> None:
    """Rank 0's parameters on every rank (the same seeds drew them alike;
    the broadcast makes sure), then this rank's shards."""
    pmesh.replicate(system.params().values())
    pmesh.place_params(system, mesh)


def _write_artifact(cfg, system: MultiTaskSystem, name: str,
                    payload: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Rank 0 writes; the payload holds whole tensors."""
    if system.mesh.rank == 0:
        save_artifact(cfg.artifact_dir, name, payload, meta=meta)
        logger.info("Saved artifact %s", name)


def train_mtl(cfg) -> Dict[str, Any]:
    """Phase-1 multi-task pretraining (reference main_temporal.py) on the
    config's ``device``, on the ``parallel`` grid of ranks."""
    setup_logging()
    check_supported(cfg)
    mesh = setup_mesh(cfg, config_device(cfg.get("device", "cuda")))
    device = mesh.device
    run_logger = make_run_logger(cfg, mesh)
    run_gen = torch.Generator()
    run_gen.manual_seed(cfg.seed if cfg.seed > 0 else 0)

    task_weights = task_weights_from_cfg(cfg)
    for t, w in task_weights.items():
        logger.info(" - Weight of %s is %s", t, w)
    name = artifact_name(cfg, task_weights)
    logger.info("This run will provide artifact %s.", name)
    # phase-1 checkpoints live apart from phase-2 ones, whose trees differ
    ckpt_dir = osp.join(cfg.checkpoint.dir, f"mtl_{name}")

    dsets = build_datasets(cfg, mesh)
    system = build_system(cfg, dsets, device)
    system.init_params(make_generator(draw_seed(run_gen), device))
    _place(system, mesh)

    active = tuple(t for t in TASKS if task_weights[t] > 0)
    # torch grad=None semantics: the backbone and the active heads train
    optimizer = instantiate(cfg.optimizer,
                            trainable_mask=topt.trainable_mask_fn(
                                ["temporal_graph"]
                                + [CKPT_KEYS[t] for t in active]))
    lr_fn = topt.build_lr_fn(cfg.optimizer.lr, instantiate(cfg.lr_scheduler),
                             cfg.use_warmup)
    opt_state = optimizer.init(system.params())

    log_norms = cfg.get("log_grad_norms", True)
    per_layer = bool(cfg.get("log_per_layer_norms", False))
    step_fn = system.make_train_step(optimizer, active, log_norms=log_norms,
                                     per_layer_norms=per_layer)
    spc = int(cfg.get("steps_per_call", 1))
    multi_fn = (system.make_train_step_multi(optimizer, active, spc,
                                             log_norms=log_norms,
                                             per_layer_norms=per_layer)
                if spc > 1 else None)
    eval_steps = make_eval_steps(system, task_weights)
    hist_fn = (system.make_histogram_fn(active)
               if int(cfg.get("log_histograms_every", 0)) > 0 else None)

    start_epoch = _maybe_resume(cfg, ckpt_dir, system, opt_state, run_gen)
    val_metrics, stats = _run_epochs(
        cfg, system=system, opt_state=opt_state, dsets=dsets,
        task_weights=task_weights, active=active, step_fn=step_fn,
        multi_fn=multi_fn, lr_fn=lr_fn, run_gen=run_gen,
        run_logger=run_logger, eval_steps=eval_steps, ckpt_dir=ckpt_dir,
        start_epoch=start_epoch,
        # validate in the last 5 epochs only (main_temporal.py:342-343)
        should_validate=lambda epoch: epoch >= cfg.num_epochs - 5,
        hist_fn=hist_fn)
    wait_for_saves()
    close_loaders(dsets)
    logger.info("Feature gathers so far: %s", native.PATH_CALLS)

    result = {"system": system, "optimizer": optimizer,
              "opt_state": opt_state, "dsets": dsets,
              "val_metrics": val_metrics, "run_dir": run_logger.dir,
              "start_epoch": start_epoch, "epochs": stats, "mesh": mesh}
    if cfg.save_model:
        payload = interop.to_flax(system.full_params())
        payload["epoch"] = np.asarray(cfg.num_epochs)
        _write_artifact(cfg, system, name, payload,
                        {"tasks": list(active), "num_epochs": cfg.num_epochs})
        result["artifact"] = name
    run_logger.close()
    return result


def _prototype_banks(cfg, system: MultiTaskSystem, dsets,
                     aux_tasks: Sequence[str]) -> Banks:
    """The aux tasks' prototype banks from one sweep over the AR train set
    at batch 256, rounded up to a multiple of the data axis, unshuffled,
    with its padded tail kept (egopack_tpu/train/driver.py:580-597): each
    rank sweeps its block of every batch and the sums are summed over the
    data axis. The batches are copied to the device a few ahead of the
    sweep; the sums accumulate in float64 on the device."""
    mesh = system.mesh
    loader = build_dataloader(dsets["ar"]["train"],
                              -(-PROTO_BATCH // mesh.data) * mesh.data,
                              False, cfg.num_workers, False, seed=cfg.seed,
                              process_shard=mh.process_shard(mesh))
    n_verbs, n_nouns = dsets["ar"]["train"].num_class_labels
    copier = DeviceCopier(system.device)
    step = make_prototype_step(system, tuple(aux_tasks), n_verbs, n_nouns)
    return build_prototypes(step, device_prefetch(iter(loader), copier.put,
                                                  copier.ready),
                            n_verbs, n_nouns, n_tasks=len(aux_tasks),
                            device=system.device, data_axis=mesh.data_axis)


def train_egopack(cfg) -> Dict[str, Any]:
    """Phase-2 EgoPack novel-task training (reference main_egopack.py;
    egopack_tpu/train/driver.py:544-723) on the config's ``device``, on
    the ``parallel`` grid of ranks."""
    setup_logging()
    if not cfg.enable_graphone:
        raise SystemExit("Invalid configuration (enable_graphone=False). "
                         "Aborting!")
    check_supported(cfg)
    if not cfg.resume_from:
        raise ValueError("EgoPack phase requires resume_from=<MTL artifact>")
    mesh = setup_mesh(cfg, config_device(cfg.get("device", "cuda")))
    device = mesh.device
    run_logger = make_run_logger(cfg, mesh)
    run_gen = torch.Generator()
    run_gen.manual_seed(cfg.seed if cfg.seed > 0 else 0)

    task_weights = task_weights_from_cfg(cfg)
    dsets = build_datasets(cfg, mesh)
    system = build_system(cfg, dsets, device, phase2=True)
    system.init_params(make_generator(draw_seed(run_gen), device))

    # the phase-1 artifact, merged with strict=False semantics
    # (main_egopack.py:286-296); its epoch is dropped
    loaded, _ = load_artifact(cfg.artifact_dir, cfg.resume_from)
    loaded.pop("epoch", None)
    merge_flax(system, loaded)
    logger.info("Resumed from %s", cfg.resume_from)
    # the mesh before the sweep, which splits over its data axis
    # (egopack_tpu/train/driver.py:573-578)
    _place(system, mesh)

    # the aux task set is the tasks named in the artifact's reference
    # (main_egopack.py:300-301)
    aux_tasks = tuple(t for t in TASKS if t in cfg.resume_from)
    t0 = time.perf_counter()
    banks = _prototype_banks(cfg, system, dsets, aux_tasks)
    sweep_s = time.perf_counter() - t0
    logger.info("Built prototype banks for %s in %.1fs (%d prototypes)",
                aux_tasks, sweep_s, next(iter(banks.values())).num_valid)

    freeze = bool(cfg.graphone.get("freeze", True))
    graphone = GraphONE(task_labels=aux_tasks,
                        features_size=cfg.model.hidden_size,
                        **to_container(cfg.graphone), device=device)
    graphone.reset_parameters(make_generator(draw_seed(run_gen), device))
    pmesh.replicate(graphone.parameters())
    # freeze=False: the bank values join the parameters and the optimizer;
    # the masks stay as built
    system.attach_graphone(graphone, None if freeze else banks)
    if not freeze:
        logger.warning("GraphONE initialized with trainable prototypes.")
    # the trained bank values split with the banks, by row over the model
    # axis (egopack_tpu/train/driver.py:620-625)
    pmesh.place_params(system, mesh)
    banks = pmesh.place_banks(banks, mesh)

    active = tuple(t for t in TASKS if task_weights[t] > 0)
    # the phase-2 loss graph: the primary heads and GraphONE (and the
    # backbone when backprop is on); the detached aux projections and the
    # other heads stay frozen
    trainable = [CKPT_KEYS[t] for t in active] + ["graphone"]
    if not freeze:
        trainable.append("graphone_banks")
    if cfg.backprop_temporal_graph:
        trainable.append("temporal_graph")
    optimizer = instantiate(cfg.optimizer,
                            trainable_mask=topt.trainable_mask_fn(trainable))
    lr_fn = topt.build_lr_fn(cfg.optimizer.lr, instantiate(cfg.lr_scheduler),
                             cfg.use_warmup)
    opt_state = optimizer.init(system.params())

    log_norms = cfg.get("log_grad_norms", True)
    per_layer = bool(cfg.get("log_per_layer_norms", False))
    modes = dict(backprop_temporal_graph=cfg.backprop_temporal_graph,
                 temporal_graph_train_mode=cfg.temporal_graph_train_mode,
                 late_fusion=cfg.late_fusion)
    step_fn = system.make_egopack_train_step(optimizer, active, graphone,
                                             log_norms=log_norms,
                                             per_layer_norms=per_layer,
                                             **modes)
    spc = int(cfg.get("steps_per_call", 1))
    multi_fn = (system.make_egopack_train_step_multi(
        optimizer, active, graphone, spc, log_norms=log_norms,
        per_layer_norms=per_layer, **modes) if spc > 1 else None)
    hist_fn = (system.make_histogram_fn(active, graphone=graphone, **modes)
               if int(cfg.get("log_histograms_every", 0)) > 0 else None)
    eval_steps = make_eval_steps(system, task_weights, aux_tasks, graphone,
                                 cfg.late_fusion)

    name = artifact_name(cfg, task_weights)
    ckpt_dir = osp.join(cfg.checkpoint.dir, f"egopack_{name}")
    start_epoch = _maybe_resume(cfg, ckpt_dir, system, opt_state, run_gen)
    val_metrics, stats = _run_epochs(
        cfg, system=system, opt_state=opt_state, dsets=dsets,
        task_weights=task_weights, active=active, step_fn=step_fn,
        multi_fn=multi_fn, lr_fn=lr_fn, run_gen=run_gen,
        run_logger=run_logger, eval_steps=eval_steps, ckpt_dir=ckpt_dir,
        start_epoch=start_epoch,
        # phase 2 validates every epoch (main_egopack.py:407-447)
        should_validate=lambda epoch: True, banks=banks,
        force_all=bool(cfg.validate_all_tasks), hist_fn=hist_fn)
    wait_for_saves()
    close_loaders(dsets)
    logger.info("Feature gathers so far: %s", native.PATH_CALLS)

    result = {"system": system, "optimizer": optimizer,
              "opt_state": opt_state, "dsets": dsets, "banks": banks,
              "graphone": graphone, "aux_tasks": aux_tasks,
              "val_metrics": val_metrics, "run_dir": run_logger.dir,
              "start_epoch": start_epoch, "epochs": stats,
              "sweep_s": sweep_s, "mesh": mesh}
    if cfg.save_model:
        # the reference persists graphone.state_dict(), bank embeddings
        # included (main_egopack.py:453-459); the banks (trained ones for
        # freeze=False) and their masks make the artifact evaluable cold;
        # split tensors are gathered whole, so it loads on any grid
        payload = interop.to_flax(system.full_params())
        whole = pmesh.gather_banks(banks, mesh)
        tasks = list(whole)
        payload["graphone_bank_masks"] = dict(zip(
            tasks, to_host([whole[t].mask for t in tasks])))
        if freeze:  # trained banks are parameters, in the payload already
            payload["graphone_banks"] = dict(zip(
                tasks, to_host([whole[t].values for t in tasks])))
        payload["epoch"] = np.asarray(cfg.num_epochs)
        _write_artifact(cfg, system, name, payload,
                        {"tasks": list(active), "phase": "egopack",
                         "aux_tasks": list(aux_tasks),
                         "graphone": to_container(cfg.graphone),
                         "late_fusion": bool(cfg.late_fusion)})
        result["artifact"] = name
    run_logger.close()
    return result
