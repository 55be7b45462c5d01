"""The phase-1 training driver (the port's counterpart of
``egopack_tpu/train/driver.py:train_mtl`` and the pieces it uses).

Reference ``main_temporal.py:137-427`` on one card: the four task datasets
and loaders, the multi-task system built from the config, multiloader
epochs of ``steps_per_call`` step groups, per-epoch loss and norm records
in ``metrics.jsonl``, validation meters in the last five epochs, optional
full-state checkpoints, and at the end the ``MTL_<sorted tasks>`` artifact
in the JAX package's format.

Randomness comes from one CPU ``torch.Generator`` per run, seeded by
``seed``: the parameters' init seed first, then two seeds per epoch (the
train steps' dropout, the LTA validation samples), each for a generator on
the run's device. A checkpoint holds that generator's state, so a resumed
run draws what the straight run draws.
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

from .. import interop
from ..config import instantiate, to_container
from ..data.loader import (DeviceCopier, MultiLoader, build_dataloader,
                           device_prefetch)
from ..device import make_generator, resolve_device
from ..eval.meters import build_meter_for_dataset
from ..eval.validate import to_host, validate, validate_lta, validate_pnr
from ..io import native
from ..models.heads import LTATask, OSCCTask, PNRTask, RecognitionTask
from ..utils.logging import RunLogger, format_run_name, setup_logging
from . import optim as topt
from .checkpoint import (latest_state, restore_state, save_artifact,
                         save_state)
from .system import CKPT_KEYS, MultiTaskSystem, TaskSetup

logger = logging.getLogger(__name__)

TASKS = ("ar", "oscc", "lta", "pnr")
TITLES = {"ar": "Recognition", "oscc": "OSCC", "lta": "LTA", "pnr": "PNR"}


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
    """Raise on the settings the port does not run yet, each naming the
    ROADMAP item that will bring it."""
    par = cfg.parallel
    if int(par.get("data", -1)) not in (1, -1) \
            or int(par.get("model", 1)) != 1 \
            or bool(par.get("multihost", False)):
        raise NotImplementedError(
            f"parallel={to_container(par)}: the port runs on one card "
            "(parallel.data 1 or -1, parallel.model 1, no multihost); "
            "multi-GPU is ROADMAP.md Queue 1 item 14")
    if bool(cfg.get("log_per_layer_norms", False)) \
            or int(cfg.get("log_histograms_every", 0)) > 0:
        raise NotImplementedError(
            "log_per_layer_norms and log_histograms_every are not ported "
            "yet; see ROADMAP.md, Queue 1 item 7")
    if bool(cfg.get("log_feature_plots", False)):
        raise NotImplementedError(
            "log_feature_plots (t-SNE) is not ported yet; see ROADMAP.md, "
            "Queue 1 item 13")
    if cfg.get("compilation_cache_dir", None):
        logger.info("compilation_cache_dir=%s is ignored: the port compiles "
                    "no XLA programs", cfg.compilation_cache_dir)


def artifact_name(cfg, task_weights: Dict[str, float]) -> str:
    """``<prefix>_<sorted enabled tasks>`` (reference main_temporal.py:159)."""
    return f"{cfg.artifact_prefix}_" + "-".join(
        sorted(t for t, w in task_weights.items() if w > 0))


def task_weights_from_cfg(cfg) -> Dict[str, float]:
    return {t: (getattr(cfg, f"weight_{t}") if t in cfg.enabled_tasks else 0)
            for t in TASKS}


def build_datasets(cfg) -> Dict[str, Dict[str, Any]]:
    """The four task datasets and their loaders (both mains build all four
    whatever ``enabled_tasks`` says, reference main_temporal.py:161-235)."""
    out = {}
    dataset_cfgs = {"ar": cfg.dataset_recognition, "oscc": cfg.dataset_oscc,
                    "lta": cfg.dataset_lta, "pnr": cfg.dataset_pnr}
    workers = int(cfg.get("loader_processes", 0))
    for name, dcfg in dataset_cfgs.items():
        train = instantiate(dcfg, split="train")
        val = instantiate(dcfg, split=cfg.validation_split)
        out[name] = {
            "train": train, "val": val,
            "dl_train": build_dataloader(train, cfg.batch_size, True,
                                         cfg.num_workers, True, seed=cfg.seed,
                                         worker_processes=workers),
            "dl_val": build_dataloader(val, cfg.batch_size, False,
                                       cfg.num_workers, False, seed=cfg.seed,
                                       worker_processes=workers),
        }
    sizes = {n: d["train"].features_size for n, d in out.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(
            f"Input features should have the same size for all tasks: {sizes}")
    return out


def build_system(cfg, dsets, device: torch.device) -> MultiTaskSystem:
    """The phase-1 system at the config's widths: ``model.*`` (hidden size,
    depth, pooling), ``oscc_feat_size``, ``task_dropout``,
    ``task_head_dropout``, ``compute_dtype``, ``fused_layout`` (the
    ``EGOPACK_FUSED_LAYOUT`` environment variable wins); class counts and
    graph specs from the datasets. Parameters are zeros until
    ``init_params``."""
    hidden = cfg.model.hidden_size
    backbone = instantiate(cfg.model, _recursive_=False,
                           input_size=dsets["ar"]["train"].features_size,
                           num_segments=cfg.dataset_recognition.num_segments,
                           device=device)
    common = dict(input_size=hidden, dropout=cfg.task_dropout,
                  head_dropout=cfg.task_head_dropout, device=device)
    heads = {
        "ar": RecognitionTask(name_="ar", features_size=hidden,
                              heads=dsets["ar"]["train"].num_class_labels,
                              **common),
        # phase-1 OSCC projects to oscc_feat_size (main_temporal.py:253)
        "oscc": OSCCTask(name_="oscc", features_size=cfg.oscc_feat_size,
                         loss_func=cfg.oscc_loss, **common),
        "lta": LTATask(name_="lta", features_size=hidden,
                       heads=dsets["lta"]["train"].num_class_labels, **common),
        "pnr": PNRTask(name_="pnr", features_size=hidden, **common),
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


def make_run_logger(cfg) -> RunLogger:
    return RunLogger(cfg.output_dir,
                     format_run_name(cfg.wandb_name_pattern,
                                     to_container(cfg)),
                     to_container(cfg))


def draw_seed(run_gen: torch.Generator) -> int:
    """The next seed from the run's generator."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=run_gen))


def _run_validation(cfg, system: MultiTaskSystem, dsets, task_weights,
                    epoch: int, run_logger: RunLogger, eval_steps,
                    generator: torch.Generator) -> Dict[str, Dict[str, Any]]:
    """The validation block (reference main_temporal.py:345-404): one meter
    per enabled task; returns ``{task: meter.get_logs()}``."""
    metrics: Dict[str, Dict[str, Any]] = {}
    for name in TASKS:
        if task_weights[name] <= 0:
            continue
        meter = build_meter_for_dataset(
            dsets[name]["val"],
            log_confusion=bool(cfg.get("log_confusion_matrices", False)))
        step, loader = eval_steps[name], dsets[name]["dl_val"]
        if name == "lta":
            validate_lta(step, None, loader, meter,
                         system.tasks["lta"].head.generate_from_logits,
                         generator, system.device)
        elif name == "pnr":
            validate_pnr(step, None, loader, meter, system.device)
        else:
            validate(step, None, loader, meter, name, system.device)
        logger.info(" ## %s ## ", TITLES[name])
        for line in meter.print_logs():
            logger.info(line)
        logs = meter.get_logs()
        run_logger.log({f"val/{name}/{k}": v for k, v in logs.items()
                        if isinstance(v, (int, float))}, step=epoch)
        if getattr(meter, "log_confusion", False):
            _write_confusion_tables(run_logger, meter, name, epoch)
        metrics[name] = logs
    return metrics


def _write_confusion_tables(run_logger: RunLogger, meter, name: str,
                            epoch: int) -> None:
    """The reference's top-2 confusion and per-class accuracy tables
    (utils/meters/ego4d.py:134-203) as JSON in the run directory. Their
    rendered heatmaps (``utils/plots.py``) are not ported yet (ROADMAP.md,
    Queue 1 item 13)."""
    tables = {which: meter.confusion_tables(which)
              for which in ("verbs", "nouns")}
    path = osp.join(run_logger.dir, f"confusion_{name}_ep{epoch}.json")
    with open(path, "w") as f:
        json.dump(tables, f)
    logger.info("Wrote confusion tables to %s (heatmaps are not rendered by "
                "the port yet)", path)


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


def _maybe_resume(cfg, ckpt_dir: str, system: MultiTaskSystem,
                  opt_state: topt.AdamState,
                  run_gen: torch.Generator) -> int:
    """Restore the newest full-state checkpoint, if checkpoints are on and
    one exists; returns the first epoch to run."""
    if not cfg.checkpoint.enable:
        return 1
    last = latest_state(ckpt_dir)
    if last is None:
        return 1
    state = restore_state(ckpt_dir, last, system.device)
    with torch.no_grad():
        for n, p in system.params().items():
            p.copy_(state["params"][n])
        for mine, saved in ((opt_state.mu, state["mu"]),
                            (opt_state.nu, state["nu"])):
            for n in mine:
                mine[n].copy_(saved[n])
    opt_state.count = int(state["count"])
    run_gen.set_state(state["generator"])
    logger.info("Resumed full state from epoch %d", last)
    return int(state["epoch"]) + 1


def _save_checkpoint(ckpt_dir: str, epoch: int, system: MultiTaskSystem,
                     opt_state: topt.AdamState,
                     run_gen: torch.Generator) -> None:
    save_state(ckpt_dir, epoch, {
        "params": {n: p.detach() for n, p in system.params().items()},
        "mu": opt_state.mu, "nu": opt_state.nu, "count": opt_state.count,
        "generator": run_gen.get_state(), "epoch": epoch})


def _run_epochs(cfg, *, system: MultiTaskSystem, opt_state, dsets,
                task_weights, active, step_fn: Callable,
                multi_fn: Optional[Callable], lr_fn, run_gen,
                run_logger, eval_steps, ckpt_dir: str, start_epoch: int,
                should_validate: Callable[[int], bool]):
    """Multiloader epochs with ``steps_per_call`` groups and a one-by-one
    tail, the per-epoch records, checkpoints and validation
    (reference main_temporal.py:300-404). The steps' logs stay on the
    device until the epoch's end. Returns (val_metrics, per-epoch stats)."""
    spc = int(cfg.get("steps_per_call", 1))
    device = system.device
    x_dtype = torch.bfloat16 if system.compute_dtype == torch.bfloat16 \
        else None
    copier = DeviceCopier(device, x_dtype)
    profiler = _Profiler(cfg.get("profile_dir", None), device)
    val_metrics: Dict[str, Any] = {}
    stats = []

    def put(tup):
        return {t: copier.put(b) for t, b in zip(TASKS, tup) if t in active}

    for epoch in range(start_epoch, cfg.num_epochs + 1):
        t0 = time.perf_counter()
        generator = make_generator(draw_seed(run_gen), device)
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
        groups = device_prefetch(iter(ml), put, copier.ready)
        while True:
            t_wait = time.perf_counter()
            batches = next(groups, None)
            data_s += time.perf_counter() - t_wait
            if batches is None:
                break
            profiler.step(n_steps, spc)
            if multi_fn is not None:
                pending.append(batches)
                if len(pending) < spc:
                    continue
                logs.append(multi_fn(opt_state, pending, generator, lr))
                pending = []
                n_steps += spc
            else:
                logs.append(step_fn(opt_state, batches, generator, lr))
                n_steps += 1
        if profiler.prof is not None:  # short epoch: close the trace
            profiler.stop()
        for batches in pending:  # the tail, one step at a time
            logs.append(step_fn(opt_state, batches, generator, lr))
            n_steps += 1
        norm_keys = sorted({k for l in logs for k in l
                            if k.startswith(("grad_norm", "param_norm"))})
        means = _epoch_means(logs, [f"{t}_loss" for t in active] + norm_keys)
        train_s = time.perf_counter() - t0
        stats.append({"epoch": epoch, "steps": n_steps, "train_s": train_s,
                      "data_s": data_s})
        losses = {t: means[f"{t}_loss"] for t in active}
        logger.info("Epoch %3d/%d (%d steps, %.1fs, lr %.2e) losses: %s; "
                    "%.2fs waiting for data", epoch, cfg.num_epochs, n_steps,
                    train_s, lr, {t: round(v, 4) for t, v in losses.items()},
                    data_s)
        run_logger.log({**{f"train/{t}/loss": v for t, v in losses.items()},
                        **{f"train/{k}": means[k] for k in norm_keys}},
                       step=epoch)
        if cfg.checkpoint.enable and epoch % cfg.checkpoint.every == 0:
            _save_checkpoint(ckpt_dir, epoch, system, opt_state, run_gen)
        if should_validate(epoch):
            val_metrics = _run_validation(cfg, system, dsets, task_weights,
                                          epoch, run_logger, eval_steps,
                                          val_generator)
    return val_metrics, stats


def train_mtl(cfg) -> Dict[str, Any]:
    """Phase-1 multi-task pretraining (reference main_temporal.py) on the
    config's ``device``."""
    setup_logging()
    check_supported(cfg)
    device = config_device(cfg.get("device", "cuda"))
    if cfg.checkpoint.get("async_write", False):
        logger.info("checkpoint.async_write: the port writes checkpoints "
                    "synchronously")
    run_logger = make_run_logger(cfg)
    run_gen = torch.Generator()
    run_gen.manual_seed(cfg.seed if cfg.seed > 0 else 0)

    task_weights = task_weights_from_cfg(cfg)
    for t, w in task_weights.items():
        logger.info(" - Weight of %s is %s", t, w)
    name = artifact_name(cfg, task_weights)
    logger.info("This run will provide artifact %s.", name)
    # phase-1 checkpoints live apart from phase-2 ones, whose trees differ
    ckpt_dir = osp.join(cfg.checkpoint.dir, f"mtl_{name}")

    dsets = build_datasets(cfg)
    system = build_system(cfg, dsets, device)
    system.init_params(make_generator(draw_seed(run_gen), device))

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
    step_fn = system.make_train_step(optimizer, active, log_norms=log_norms)
    spc = int(cfg.get("steps_per_call", 1))
    multi_fn = (system.make_train_step_multi(optimizer, active, spc,
                                             log_norms=log_norms)
                if spc > 1 else None)
    eval_steps = {t: system.make_eval_step(t) for t in TASKS}

    start_epoch = _maybe_resume(cfg, ckpt_dir, system, opt_state, run_gen)
    val_metrics, stats = _run_epochs(
        cfg, system=system, opt_state=opt_state, dsets=dsets,
        task_weights=task_weights, active=active, step_fn=step_fn,
        multi_fn=multi_fn, lr_fn=lr_fn, run_gen=run_gen,
        run_logger=run_logger, eval_steps=eval_steps, ckpt_dir=ckpt_dir,
        start_epoch=start_epoch,
        # validate in the last 5 epochs only (main_temporal.py:342-343)
        should_validate=lambda epoch: epoch >= cfg.num_epochs - 5)
    logger.info("Feature gathers so far: %s", native.PATH_CALLS)

    result = {"system": system, "optimizer": optimizer,
              "opt_state": opt_state, "dsets": dsets,
              "val_metrics": val_metrics, "run_dir": run_logger.dir,
              "start_epoch": start_epoch, "epochs": stats}
    if cfg.save_model:
        payload = interop.to_flax(system.params())
        payload["epoch"] = np.asarray(cfg.num_epochs)
        save_artifact(cfg.artifact_dir, name, payload,
                      meta={"tasks": list(active),
                            "num_epochs": cfg.num_epochs})
        logger.info("Saved artifact %s", name)
        result["artifact"] = name
    run_logger.close()
    return result
