"""Cold evaluation of an artifact, the port's CLI (counterpart of
``egopack_tpu/evaluate.py``).

Loads a phase-1 ``MTL_*`` or a phase-2 EgoPack artifact, rebuilds the
system for its phase (for EgoPack artifacts, GraphONE and the prototype
banks from the payload alone, without a sweep of the AR train set) and runs
the validation loops of the training drivers once, as epoch 0::

    python -m egopack_torch.evaluate resume_from=MTL_oscc \\
        [validation_split=val] [output=metrics.json] [overrides...]

The validated tasks are the artifact's ``meta.tasks``, all four with
``validate_all_tasks=True``. It runs on the card; ``device=cpu`` runs it on
the CPU.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any, Dict, List, Optional

import torch

from .config import compose, default_config_dir, to_container
from .data.loader import close_loaders
from .device import make_generator
from .train import driver as drv
from .train.checkpoint import load_artifact, unpack_artifact
from .utils.logging import RunLogger, setup_logging

logger = logging.getLogger(__name__)


def evaluate(cfg, output: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Validate the artifact ``cfg.resume_from``; returns
    ``{task: meter logs}`` and writes them as JSON to ``output``."""
    setup_logging()
    drv.check_supported(cfg)
    if not cfg.resume_from:
        raise ValueError("evaluate requires resume_from=<artifact>")
    device = drv.config_device(cfg.get("device", "cuda"))
    payload, meta = load_artifact(cfg.artifact_dir, cfg.resume_from)
    phase2, banks, graphone, aux_tasks, late_fusion, extra = unpack_artifact(
        payload, meta, cfg, device)

    dsets = drv.build_datasets(cfg)
    system = drv.build_system(cfg, dsets, device, phase2=phase2)
    run_gen = torch.Generator()
    run_gen.manual_seed(cfg.seed if cfg.seed > 0 else 0)
    system.init_params(make_generator(drv.draw_seed(run_gen), device))
    if phase2:
        system.attach_graphone(graphone, banks if "graphone_banks" in extra
                               else None)
    payload.update(extra)
    drv.merge_flax(system, payload)

    eval_tasks = list(meta.get("tasks") or cfg.enabled_tasks)
    task_weights = {t: (1.0 if t in eval_tasks else 0.0) for t in drv.TASKS}
    eval_steps = drv.make_eval_steps(system, task_weights, aux_tasks,
                                     graphone, late_fusion)

    run_logger = RunLogger(cfg.output_dir,
                           f"eval_{cfg.resume_from.split('/')[-1]}",
                           to_container(cfg))
    metrics = drv._run_validation(
        cfg, system, dsets, task_weights, 0, run_logger, eval_steps,
        make_generator(drv.draw_seed(run_gen), device), banks,
        force_all=bool(cfg.get("validate_all_tasks", False)))
    close_loaders(dsets)
    run_logger.close()
    if output:
        with open(output, "w") as f:
            json.dump(metrics, f, indent=2, default=float)
        logger.info("Wrote metrics to %s", output)
    return metrics


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, Any]]:
    argv = list(argv if argv is not None else sys.argv[1:])
    output = None
    overrides = []
    for a in argv:
        if a.startswith("output="):
            output = a.split("=", 1)[1]
        else:
            overrides.append(a)
    cfg = compose(default_config_dir(), "defaults", overrides=overrides)
    return evaluate(cfg, output)


if __name__ == "__main__":
    main()
