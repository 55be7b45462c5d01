"""A phase-1 configuration of each published task set joins the benchmark as
new files only: ``egopack-mtl-ar-lta-pnr``'s configuration with the set's
``tasks`` and a copy of ``mtl-step``'s limits under a cell of its own,
written into a copy of the benchmark beside the others, with no existing
file of the copy edited. Each reads correct at tiny widths on the CPU, and
each reads not correct with the step broken underneath."""

import json
import re
import shutil
import time

import pytest
import torch

from benchmark.harness import faults, inputs
from benchmark.harness.cell import run_cell
from benchmark.harness.manifest import Manifest
from benchmark.harness.program import ProgramStep
from benchmark.reference import model as ref
from benchmark.reference import params
from benchmark.tests.tiny import ROOT, TINY

FAULTS = ("half_batch", "few_frozen", "unchanged")


def published_sets():
    """The task sets of ``experiments/mtl.yaml``'s sweep, in its order."""
    text = (ROOT / "experiments" / "mtl.yaml").read_text()
    block = text.split("enabled_tasks:", 1)[1].split("command:", 1)[0]
    return [tuple(t.strip() for t in m.split(","))
            for m in re.findall(r"^\s*-\s*\[([\w\s,]+)\]\s*$", block, re.M)]


SETS = published_sets()


def _name(tasks) -> str:
    return "test-mtl-" + "-".join(tasks)


def published_config(tasks) -> dict:
    cfg = Manifest(ROOT).config("egopack-mtl-ar-lta-pnr")
    return {**cfg, "name": _name(tasks), "tasks": list(tasks)}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with the four configurations added as new
    files and new entries; fails if an existing file would change."""
    root = tmp_path_factory.mktemp("phase1") / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    limits = (root / "benchmark" / "limits" / "mtl-step.json").read_text()
    for tasks in SETS:
        cfg = published_config(tasks)
        name, cell = cfg["name"], f"{cfg['name']}-step"
        path = root / "benchmark" / "configs" / f"{name}.json"
        assert not path.exists()
        path.write_text(json.dumps(cfg))
        path = root / "benchmark" / "limits" / f"{cell}.json"
        assert not path.exists()
        path.write_text(limits)
        bench["configs"].append(
            {"name": name, "source": cfg["source"],
             "file": f"benchmark/configs/{name}.json", "reduced": [],
             "why": f"phase-1 multi-task training of {list(tasks)}"})
        bench["workloads"].append(
            {"name": cell, "config": name, "traffic": "device_pool",
             "chips": 1, "why": f"phase-1 step of {list(tasks)}"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path in (root / "benchmark").rglob("*"):
        mine = ROOT / path.relative_to(root)
        if path.is_file() and mine.is_file():
            assert path.read_bytes() == mine.read_bytes(), path
    return root


def _run(root, tasks, fault=None):
    try:
        return run_cell(Manifest(root), f"{_name(tasks)}-step", 13, 0.3,
                        False, torch.device("cpu"), time.perf_counter(),
                        overrides=TINY, fault=fault, log=lambda line: None)
    finally:
        faults.restore()


def test_the_sweep_trains_four_sets_three_with_oscc():
    assert len(SETS) == 4 and len(set(SETS)) == 4
    assert ("ar", "lta", "pnr") in SETS
    assert sum("oscc" in s for s in SETS) == 3


@pytest.mark.parametrize("tasks", SETS, ids=_name)
def test_task_set_is_correct(checkout, tasks):
    out = _run(checkout, tasks)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("tasks,fault", [(s, f) for s in SETS
                                         for f in FAULTS],
                         ids=lambda v: v if isinstance(v, str) else _name(v))
def test_task_set_broken_is_not_correct(checkout, tasks, fault):
    out = _run(checkout, tasks, faults.FAULTS[fault])
    assert not out["correct"], out["checks"]


def _tiny(tasks) -> dict:
    return {**published_config(tasks), **TINY}


def _program(cfg, seeds, dev=torch.device("cpu")):
    weights = params.init_params(cfg, inputs.generator(seeds["weights"], dev),
                                 dev)
    return ProgramStep(cfg, weights, None,
                       inputs.generator(seeds["dropout"], dev), dev)


@pytest.mark.parametrize("tasks", SETS, ids=_name)
def test_few_frozen_freezes_a_trainable_leaf(tasks):
    """In every set the fault holds some trainable leaves still: the PNR
    head's where PNR trains, else the OSCC head's."""
    cfg = _tiny(tasks)
    seeds = inputs.stream_seeds(17)
    step = faults.few_frozen(_program(cfg, seeds))
    batches = inputs.batch_pool(cfg, 1, seeds["batches"],
                                torch.device("cpu"))[0]
    live = step.system.params()
    before = {n: live[n].detach().clone() for n in step.trainable_names()}
    step(batches)
    held = [n for n, p in before.items() if torch.equal(p, live[n])]
    head = "task.pnr." if "pnr" in tasks else "task.oscc."
    assert held and all(n.startswith(head) for n in held), held
    assert sorted(held) == sorted(n for n in before if n.startswith(head))


def test_phase1_oscc_loss_is_the_programs():
    """The reference's phase-1 OSCC loss (each clip's nodes max-pooled, a
    2-way classifier, plain cross entropy over the clips) against the
    program's ``oscc_loss`` on the first step, on a seed with no tie of the
    max within ``NODE_TIE_SLACK``. The tolerance, 1e-6 of the loss, is
    float32 rounding of one pooled 2-way cross entropy over 4 clips."""
    cfg = _tiny(("ar", "oscc", "lta"))
    dev = torch.device("cpu")
    seeds = inputs.stream_seeds(2147483659)
    batches = inputs.batch_pool(cfg, 1, seeds["batches"], dev)[0]
    logs = _program(cfg, seeds)(batches)
    weights = params.init_params(cfg, inputs.generator(seeds["weights"], dev),
                                 dev)
    node_max = ref.NodeMax(ref.NODE_TIE_SLACK, ref.NODE_TIES_TRIED)
    parts = ref.phase1_losses(weights, cfg, batches,
                              inputs.generator(seeds["dropout"], dev),
                              node_max)
    assert node_max.calls == 1 and node_max.ties == []
    want, got = float(parts["oscc"]), float(logs["oscc_loss"])
    assert got == pytest.approx(want, rel=1e-6)
