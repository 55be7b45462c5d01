"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the cells. Each piece a
cell names lives in a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the configuration's sizes and settings;
- ``traffic/<traffic>.json``: the traffic mix, parameters that its feed
  kind reads;
- ``feeds/<kind>.py``: a feed kind, named by a mix's ``feed`` key: a
  ``make(cfg, traffic, seed, device)`` whose feed hands the step its batch
  groups, and a ``reference_groups(...)`` that makes the first of them
  again for the reference;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
- ``metrics/<metric>.py``: one per-layer metric, a ``read(ctx)`` that
  returns its value or None.

A later cell, mix or metric is new files and new entries, never an edit.

A phase-1 configuration (``"phase": 1``) of any published task set
(``experiments/mtl.yaml``: ``[ar, oscc, lta]``, ``[ar, oscc, pnr]``,
``[ar, lta, pnr]``, ``[oscc, lta, pnr]``) is new files only: ``tasks``
lists the set in the order the step takes it, and the reference's loss
(``reference/model.py:phase1_losses``) has each of the four tasks.

A phase-2 configuration (``"phase": 2``) of any novel task gives, beside
the sizes a phase-1 one gives: ``tasks`` (the novel task alone),
``aux_tasks`` (the tasks of its prototype banks and GraphONE, in the
published trainer's order ar, oscc, lta, pnr), ``head_aux`` (each head's
aux classifier sets; without it, the narrower sets ``egopack-novel-oscc``
is built with), ``backprop_temporal_graph``,
``temporal_graph_train_mode``, ``late_fusion``, ``task_head_dropout``,
``graphone`` (``k``, ``depth``, ``hidden_size``, ``residual``,
``distance_func``, ``freeze``) and ``banks`` (``rows``, ``valid``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Manifest:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "benchmark"
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, *parts: str) -> Dict[str, Any]:
        with open(self.bench_dir.joinpath(*parts)) as f:
            return json.load(f)

    def config(self, name: str) -> Dict[str, Any]:
        return self._json("configs", f"{name}.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> Dict[str, Any]:
        return self._json("limits", f"{cell}.json")

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell])]

    def _module(self, folder: str, name: str) -> ModuleType:
        path = self.bench_dir / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{folder}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metric_module(self, name: str) -> ModuleType:
        return self._module("metrics", name)

    def feed(self, kind: str) -> ModuleType:
        return self._module("feeds", kind)

    def setting(self, cell: str):
        """``(configuration, traffic mix, feed kind)`` of ``cell``."""
        w = self.cell(cell)
        traffic = self.traffic(w["traffic"])
        return self.config(w["config"]), traffic, self.feed(traffic["feed"])

    def read_metrics(self, cell: str, ctx: Any) -> Dict[str, Dict[str, Any]]:
        """Each per-layer metric of ``cell`` that finds something to read."""
        out = {}
        for m in self.per_layer(cell):
            value: Optional[float] = self.metric_module(m["name"]).read(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
