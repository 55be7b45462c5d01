"""The system under test: the program's train step at a configuration,
built from the program's public pieces as its drivers build it
(``egopack_torch/train/driver.py``), with the benchmark's weights loaded.

The harness builds the program here; beside this module only the faults,
which patch it, and the run's count of the k-NN's launches reach into it."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from egopack_torch import entry
from egopack_torch.data import graphs as G
from egopack_torch.models.backbone import TemporalGraph
from egopack_torch.models.graphone import GraphONE, PrototypeBank
from egopack_torch.models.heads import (LTATask, OSCCTask, PNRTask,
                                        RecognitionTask)
from egopack_torch.models.pooling import TRNPooling
from egopack_torch.train import optim as topt
from egopack_torch.train.system import CKPT_KEYS, MultiTaskSystem, TaskSetup

from ..reference.params import head_aux

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _phase2_system(cfg: dict, device: torch.device) -> MultiTaskSystem:
    """``driver.build_system(phase2=True)`` at the configuration: every head
    with the aux classifier sets the configuration gives it (``head_aux``)
    and the head dropout, OSCC projecting to the hidden width and averaging
    its logits."""
    h, d, s = cfg["hidden_size"], cfg["feature_dim"], cfg["num_segments"]
    pooling = TRNPooling(d, h, s, hidden_size=cfg["tp_hidden_size"],
                         dropout=cfg["tp_dropout"], device=device)
    backbone = TemporalGraph(d, h, depth=cfg["depth"],
                             temporal_pooling=pooling, num_segments=s,
                             device=device)
    common = dict(input_size=h, features_size=h, dropout=0.0,
                  head_dropout=cfg["task_head_dropout"], device=device)
    classes = (cfg["n_verbs"], cfg["n_nouns"])
    aux = head_aux(cfg)
    heads = {
        "ar": RecognitionTask("ar", heads=classes, aux_tasks=aux["ar"],
                              **common),
        "oscc": OSCCTask("oscc", loss_func="ce", aux_tasks=aux["oscc"],
                         average_logits=True, **common),
        "lta": LTATask("lta", heads=classes, aux_tasks=aux["lta"], **common),
        "pnr": PNRTask("pnr", aux_tasks=aux["pnr"], **common),
    }
    k = cfg["graph_k"]
    specs = {"ar": G.ar_spec(cfg["nodes"]["ar"], k), "oscc": G.oscc_spec(k),
             "lta": G.lta_spec(cfg["lta_input_clips"],
                               cfg["nodes"]["lta"] - cfg["lta_input_clips"],
                               k),
             "pnr": G.pnr_spec(cfg["nodes"]["pnr"], k)}
    tasks = {n: TaskSetup(n, heads[n], specs[n],
                          1.0 if n in cfg["tasks"] else 0.0,
                          append_node="avg" if n == "lta" else None)
             for n in heads}
    return MultiTaskSystem(backbone, tasks, DTYPES[cfg["compute_dtype"]],
                           cfg["fused_layout"], device=device)


class ProgramStep:
    """One optimizer step of the program a call, on a batch group:
    ``logs = step(batches)``. Holds the model, Adam's state, the dropout
    generator and, in phase 2, GraphONE and the banks."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 banks: Optional[dict], dropout_gen: torch.Generator,
                 device: torch.device):
        self.cfg = cfg
        self.active = tuple(cfg["tasks"])
        self.generator = dropout_gen
        self.lr = cfg["lr"]
        if cfg["phase"] == 1:
            self.system = entry.build_system(
                cfg["hidden_size"], cfg["tp_hidden_size"], cfg["feature_dim"],
                cfg["num_segments"], cfg["tp_dropout"],
                compute_dtype=DTYPES[cfg["compute_dtype"]],
                fused_layout=cfg["fused_layout"], device=device)
            trainable = ["temporal_graph"] + [CKPT_KEYS[t]
                                              for t in self.active]
        else:
            self.system = _phase2_system(cfg, device)
            g = cfg["graphone"]
            self.graphone = GraphONE(
                tuple(cfg["aux_tasks"]), features_size=cfg["hidden_size"],
                hidden_size=g["hidden_size"], freeze=g["freeze"], k=g["k"],
                depth=g["depth"], distance_func=g["distance_func"],
                residual=g["residual"], device=device)
            self.system.attach_graphone(self.graphone)
            trainable = ([CKPT_KEYS[t] for t in self.active] + ["graphone"]
                         + (["temporal_graph"]
                            if cfg["backprop_temporal_graph"] else []))
            self.banks = {t: PrototypeBank(v, m)
                          for t, (v, m) in banks.items()}
        with torch.no_grad():
            self.system.load_state(weights)
        self.optimizer = topt.adam(
            cfg["lr"], cfg["weight_decay"],
            trainable_mask=topt.trainable_mask_fn(trainable),
            moments_dtype=cfg["moments_dtype"], impl=cfg["adam_impl"])
        self.opt_state = self.optimizer.init(self.system.params())
        if cfg["phase"] == 1:
            self._step = self.system.make_train_step(
                self.optimizer, self.active,
                log_norms=cfg["log_grad_norms"])
        else:
            self._step = self.system.make_egopack_train_step(
                self.optimizer, self.active, self.graphone,
                backprop_temporal_graph=cfg["backprop_temporal_graph"],
                temporal_graph_train_mode=cfg["temporal_graph_train_mode"],
                late_fusion=cfg["late_fusion"],
                log_norms=cfg["log_grad_norms"])

    def trainable_names(self) -> List[str]:
        return self.optimizer.trainable_names(self.system.params())

    def __call__(self, batches) -> Dict[str, torch.Tensor]:
        if self.cfg["phase"] == 1:
            return self._step(self.opt_state, batches, self.generator,
                              self.lr)
        return self._step(self.opt_state, self.banks, batches,
                          self.generator, self.lr)

    def total_loss(self, logs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return sum(logs[f"{t}_loss"] for t in self.active)


def knn_recorder() -> Callable[[], list]:
    """Record what the program's k-NN returns inside GraphONE: wraps the
    function GraphONE calls and returns ``stop()``, which puts it back and
    returns the ``(indices, distances)`` of every call since."""
    from egopack_torch.models import graphone as module
    original = module.prototype_topk
    seen: list = []

    def recording(*args, **kwargs):
        idx, dist = original(*args, **kwargs)
        seen.append((idx.clone(), dist.clone()))
        return idx, dist

    module.prototype_topk = recording

    def stop() -> list:
        module.prototype_topk = original
        return seen

    return stop
