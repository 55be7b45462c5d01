"""A phase-2 configuration of each published novel task joins the benchmark
as new files only: its configuration, its limits and its entries in
``BENCHMARK.json``, written into a copy of the benchmark beside the
others, with no existing file of the copy edited. Each reads correct at
tiny widths on the CPU, and each reads not correct with the step broken
underneath."""

import json
import re
import shutil
import time

import pytest
import torch

from benchmark.harness import faults
from benchmark.harness.cell import run_cell
from benchmark.harness.manifest import Manifest
from benchmark.tests.tiny import ROOT, TINY_PHASE2

TASKS = ("ar", "oscc", "lta", "pnr")  # the published trainer's order
SOURCE = "https://github.com/sapeirone/EgoPack/blob/main/experiments/egopack"
FAULTS = ("half_batch", "few_frozen", "knn_duplicate")


def _sweep(task: str) -> dict:
    """The ``key=value`` words of ``experiments/egopack/<task>.yaml``'s
    command."""
    text = (ROOT / "experiments" / "egopack" / f"{task}.yaml").read_text()
    return dict(re.findall(r"^\s*-\s*([\w./]+)=(\S+)\s*$", text, re.M))


def _flag(value: str) -> bool:
    return {"True": True, "False": False}[value]


def published_config(task: str) -> dict:
    """The phase-2 configuration of novel ``task`` as its sweep runs it,
    on ``egopack-novel-oscc``'s sizes: the modes, the learning rate, the
    aux tasks of the artifact it resumes from and the published trainer's
    aux classifier sets (each head gets the other three tasks)."""
    w = _sweep(task)
    assert w["enabled_tasks"] == f"[{task}]"
    cfg = Manifest(ROOT).config("egopack-novel-oscc")
    g = {**cfg["graphone"], "k": int(w["graphone.k"]),
         "hidden_size": int(w["graphone.hidden_size"]),
         "residual": _flag(w["graphone.residual"])}
    return {**cfg, "name": f"test-novel-{task}",
            "source": f"{SOURCE}/{task}.yaml", "tasks": [task],
            "aux_tasks": [t for t in TASKS if t in w["resume_from"]],
            "head_aux": {h: [t for t in TASKS if t != h] for h in TASKS},
            "lr": float(w["optimizer.lr"]),
            "task_head_dropout": float(w["task_head_dropout"]),
            "backprop_temporal_graph": _flag(w["backprop_temporal_graph"]),
            "temporal_graph_train_mode": _flag(
                w["temporal_graph_train_mode"]),
            "late_fusion": _flag(w["late_fusion"]), "graphone": g}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with the four configurations added as new
    files and new entries; fails if an existing file would change."""
    root = tmp_path_factory.mktemp("novel") / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    limits = (root / "benchmark" / "limits" / "novel-oscc-step.json"
              ).read_text()
    for task in TASKS:
        cfg = published_config(task)
        name, cell = cfg["name"], f"test-novel-{task}-step"
        path = root / "benchmark" / "configs" / f"{name}.json"
        assert not path.exists()
        path.write_text(json.dumps(cfg))
        path = root / "benchmark" / "limits" / f"{cell}.json"
        assert not path.exists()
        path.write_text(limits)
        bench["configs"].append(
            {"name": name, "source": cfg["source"],
             "file": f"benchmark/configs/{name}.json", "reduced": [],
             "why": f"phase-2 novel {task}"})
        bench["workloads"].append(
            {"name": cell, "config": name, "traffic": "device_pool",
             "chips": 1, "why": f"phase-2 novel {task} step"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path in (root / "benchmark").rglob("*"):
        mine = ROOT / path.relative_to(root)
        if path.is_file() and mine.is_file():
            assert path.read_bytes() == mine.read_bytes(), path
    return root


def _run(root, task, fault=None):
    try:
        return run_cell(Manifest(root), f"test-novel-{task}-step", 11, 0.3,
                        False, torch.device("cpu"), time.perf_counter(),
                        overrides=TINY_PHASE2, fault=fault,
                        log=lambda line: None)
    finally:
        faults.restore()


def test_published_modes():
    """The sweeps' modes: only novel LTA freezes the backbone."""
    frozen = {t for t in TASKS
              if not published_config(t)["backprop_temporal_graph"]}
    assert frozen == {"lta"}
    assert published_config("lta")["aux_tasks"] == ["ar", "oscc", "pnr"]
    assert published_config("oscc")["aux_tasks"] == ["ar", "lta", "pnr"]


@pytest.mark.parametrize("task", TASKS)
def test_novel_task_is_correct(checkout, task):
    out = _run(checkout, task)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["knn_slack"]["value"] < 1e-6


@pytest.mark.parametrize("task,fault", [(t, f) for t in TASKS
                                        for f in FAULTS])
def test_novel_task_broken_is_not_correct(checkout, task, fault):
    out = _run(checkout, task, faults.FAULTS[fault])
    assert not out["correct"], out["checks"]
