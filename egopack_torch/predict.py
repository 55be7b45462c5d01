"""Challenge predictions from an artifact (the port's counterpart of
``egopack_tpu/predict.py``): the Ego4D submission files of the unannotated
test splits.

- **LTA** (the challenge's JSON): ``{"<clip_uid>_<last_idx>": {"verb":
  [[...] * K], "noun": [[...] * K]}}``, K=5 sequences of 20 per head,
  sampled by ``LTATask.generate_from_logits`` from a generator seeded by
  ``seed``. JAX's samples cannot be matched; they agree in distribution.
- **OSCC**: ``{"<unique_id>": {"state_change": bool, "prob_change": p}}``.
- **PNR**: ``{"<unique_id>": {"pnr_frame": f}}``, the node argmax mapped to
  a frame of the parent video by the localization meter's ``(end - start)
  / 16`` rule (reference utils/meters/ego4d.py:356-366).

Usage::

    python -m egopack_torch.predict resume_from=MTL_ar-lta-pnr \\
        dataset_lta.root=data/ego4d validation_split=test_unannotated \\
        task=lta output=lta_predictions.json

It runs on the card; ``device=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import compose, default_config_dir, instantiate
from .data.graphs import ar_spec, lta_spec, oscc_spec, pnr_spec
from .data.loader import build_dataloader
from .device import make_generator
from .eval.validate import paired_batches, to_host
from .models.heads import LTATask, OSCCTask, PNRTask, RecognitionTask
from .train import driver as drv
from .train.checkpoint import load_artifact, unpack_artifact
from .train.system import MultiTaskSystem, TaskSetup
from .utils.logging import setup_logging

logger = logging.getLogger(__name__)

DATASET_KEYS = {"ar": "dataset_recognition", "oscc": "dataset_oscc",
                "lta": "dataset_lta", "pnr": "dataset_pnr"}


def _only_key(node: dict) -> str:
    (key,) = node.keys()
    return key


def _infer_class_heads(payload: dict) -> Tuple[int, int]:
    """(n_verbs, n_nouns) from the artifact's AR classifier kernels, so an
    OSCC or PNR predictor runs without the fho_lta annotation files."""
    node = payload["task/recognition"]
    sizes = []
    for i in (0, 1):
        cls = node[f"cls{i}"]
        sizes.append(int(np.asarray(cls[_only_key(cls)]["kernel"]).shape[1]))
    return tuple(sizes)


class Predictor:
    """An artifact's system and eval step for one primary task, built from
    a single dataset, the task's split (``validation_split``), so that the
    other tasks' annotation files are not needed. A phase-2 artifact brings
    its prototype banks and GraphONE (``unpack_artifact``)."""

    def __init__(self, cfg, task: str):
        if not cfg.resume_from:
            raise ValueError("predict requires resume_from=<artifact>")
        drv.check_supported(cfg)
        self.task = task
        self.cfg = cfg
        self.device = drv.config_device(cfg.get("device", "cuda"))
        dset = instantiate(cfg[DATASET_KEYS[task]],
                           split=cfg.validation_split)
        self.dset = dset
        hidden = cfg.model.hidden_size
        # segments a node are the AR/LTA sampling count, as in the drivers
        backbone = instantiate(cfg.model, _recursive_=False,
                               input_size=dset.features_size,
                               num_segments=cfg.dataset_recognition.num_segments,
                               device=self.device)
        payload, meta = load_artifact(cfg.artifact_dir, cfg.resume_from)
        self.meta = meta
        phase2, banks, graphone, aux_tasks, late_fusion, extra = \
            unpack_artifact(payload, meta, cfg, self.device)
        self.aux = (tuple(t for t in aux_tasks if t != task) if phase2
                    else None)
        class_heads = (dset.num_class_labels if task in ("ar", "lta")
                       else _infer_class_heads(payload))

        def aux_of(name):
            return self.aux if name == task else None

        common = dict(input_size=hidden, device=self.device)
        heads = {
            "ar": RecognitionTask(name_="ar", features_size=hidden,
                                  heads=class_heads, aux_tasks=aux_of("ar"),
                                  **common),
            "oscc": OSCCTask(name_="oscc",
                             features_size=hidden if phase2
                             else cfg.oscc_feat_size,
                             aux_tasks=aux_of("oscc"), **common),
            "lta": LTATask(name_="lta", features_size=hidden,
                           heads=class_heads, aux_tasks=aux_of("lta"),
                           **common),
            "pnr": PNRTask(name_="pnr", features_size=hidden,
                           aux_tasks=aux_of("pnr"), **common),
        }
        specs = {"ar": ar_spec(9, cfg.k), "oscc": oscc_spec(cfg.k),
                 "lta": lta_spec(k=cfg.k), "pnr": pnr_spec(16, cfg.k)}
        specs[task] = dset.graph_spec(cfg.k)
        lta_append = (dset.append_node if task == "lta"
                      else cfg.dataset_lta.get("append_node", "avg"))
        self.system = MultiTaskSystem(
            backbone, {n: TaskSetup(n, heads[n], specs[n],
                                    append_node=lta_append if n == "lta"
                                    else None)
                       for n in heads}, device=self.device)
        self.system.init_params(make_generator(cfg.seed, self.device))
        if phase2:
            self.system.attach_graphone(
                graphone, banks if "graphone_banks" in extra else None)
            logger.info("EgoPack artifact: predicting with %s-bank "
                        "interaction", "/".join(self.aux))
        payload.update(extra)
        drv.merge_flax(self.system, payload)
        self.banks = banks
        self.eval_step = self.system.make_eval_step(
            task, aux=self.aux or (), graphone=graphone,
            late_fusion=late_fusion)

    def batches(self):
        """(host batch, device batch) pairs over the split, in order."""
        cfg = self.cfg
        loader = build_dataloader(self.dset, cfg.batch_size, False,
                                  cfg.num_workers, False, seed=cfg.seed)
        return paired_batches(loader, self.device)


def predict_lta(cfg, output: str = "lta_predictions.json"
                ) -> Dict[str, dict]:
    setup_logging()
    p = Predictor(cfg, "lta")
    sample = p.system.tasks["lta"].head.generate_from_logits
    generator = make_generator(cfg.seed, p.device)
    n_input = p.dset.n_input_clips
    predictions: Dict[str, dict] = {}
    for batch, dbatch in p.batches():
        logits = p.eval_step(dbatch, p.banks)[0]
        preds, _ = sample(logits, generator)
        verbs, nouns = to_host(preds)  # (B, N, K)
        for b, valid in enumerate(batch["valid"]):
            if valid:
                key = f"{batch['clip_uid'][b]}_{batch['last_idx'][b]}"
                predictions[key] = {"verb": verbs[b, n_input:].T.tolist(),
                                    "noun": nouns[b, n_input:].T.tolist()}
    _write(predictions, output, "LTA")
    return predictions


def predict_oscc(cfg, output: str = "oscc_predictions.json"
                 ) -> Dict[str, dict]:
    setup_logging()
    p = Predictor(cfg, "oscc")
    predictions: Dict[str, dict] = {}
    for batch, dbatch in p.batches():
        logits = p.eval_step(dbatch, p.banks)[0]
        (probs,) = to_host([torch.softmax(logits.float(), -1)])  # (B, 2)
        for b, valid in enumerate(batch["valid"]):
            if valid:
                predictions[str(batch["uid"][b])] = {
                    "state_change": bool(probs[b, 1] > probs[b, 0]),
                    "prob_change": float(probs[b, 1])}
    _write(predictions, output, "OSCC")
    return predictions


def predict_pnr(cfg, output: str = "pnr_predictions.json"
                ) -> Dict[str, dict]:
    setup_logging()
    p = Predictor(cfg, "pnr")
    predictions: Dict[str, dict] = {}
    for batch, dbatch in p.batches():
        (logits,) = to_host([p.eval_step(dbatch, p.banks)[0]])  # (B, 16)
        starts = np.asarray(batch["start_frame"])
        ends = np.asarray(batch["end_frame"])
        # the localization meter's mapping (reference ego4d.py:356-366)
        frames = starts + (ends - starts) / logits.shape[1] * logits.argmax(-1)
        for b, valid in enumerate(batch["valid"]):
            if valid:
                predictions[str(batch["uid"][b])] = {
                    "pnr_frame": float(frames[b])}
    _write(predictions, output, "PNR")
    return predictions


def _write(predictions: dict, output: str, label: str) -> None:
    with open(output, "w") as f:
        json.dump(predictions, f)
    logger.info("Wrote %d %s predictions to %s", len(predictions), label,
                output)


PREDICTORS = {"lta": predict_lta, "oscc": predict_oscc, "pnr": predict_pnr}


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    argv = list(argv if argv is not None else sys.argv[1:])
    output = None
    task = "lta"
    overrides = []
    for a in argv:
        if a.startswith("output="):
            output = a.split("=", 1)[1]
        elif a.startswith("task="):
            task = a.split("=", 1)[1]
        else:
            overrides.append(a)
    if task not in PREDICTORS:
        raise ValueError(
            f"task={task} has no prediction writer (choose from "
            f"{sorted(PREDICTORS)}; AR windows come from the fho_lta "
            "annotations, which ship no unannotated split)")
    cfg = compose(default_config_dir(), "defaults", overrides=overrides)
    return PREDICTORS[task](cfg, output or f"{task}_predictions.json")


if __name__ == "__main__":
    main()
