"""BENCHMARK.json against the contract's rules, and finding each cell's
pieces by name."""

import json
import re
import shutil

import pytest

import time

import torch

from benchmark.harness.cell import run_cell
from benchmark.harness.manifest import Manifest
from benchmark.tests.tiny import ROOT, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names(bench):
    assert set(bench) == TOP
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["command"] == ["python3", "benchmark/run.py"]
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells)), m["name"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])


def test_every_piece_found_by_name(bench):
    m = Manifest(ROOT)
    for w in bench["workloads"]:
        cfg = m.config(w["config"])
        assert cfg["name"] == w["config"]
        cfg_, traffic, kind = m.setting(w["name"])
        assert callable(kind.make) and callable(kind.reference_groups)
        assert m.limits(w["name"])["limits"]
        for metric in m.per_layer(w["name"]):
            assert callable(m.metric_module(metric["name"]).read)
    for c in bench["configs"]:
        cfg = m.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


NEW_FEED = '''"""A test feed kind: the device pool's groups in reverse order."""
from benchmark.feeds import device_pool


class Reversed(device_pool.DevicePool):
    def __init__(self, *args):
        super().__init__(*args)
        self.groups.reverse()
        self.clips.reverse()


def make(cfg, traffic, seed, device):
    return Reversed(cfg, traffic, seed, device)


def reference_groups(cfg, traffic, seed, device, n):
    return Reversed(cfg, traffic, seed, device).groups[:n]
'''

NEW_METRIC = '''"""The window's wait for data, ms a step."""


def read(ctx):
    w = ctx.window
    return w.data_s / w.host_steps * 1e3 if w.host_steps else None
'''


def test_new_cell_and_metric_are_new_files(tmp_path, bench):
    """A later cell, mix, feed kind and metric: files added beside the
    others and entries added to BENCHMARK.json; no existing file of the
    benchmark is edited, and a run of the new cell finds them all."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    (root / "benchmark" / "traffic" / "device_pool_small.json").write_text(
        json.dumps({"feed": "reversed_pool", "groups": 8}))
    (root / "benchmark" / "feeds" / "reversed_pool.py").write_text(NEW_FEED)
    (root / "benchmark" / "limits" / "mtl-step-small.json").write_text(
        json.dumps({"limits": {"loss_gap": {"limit": 1e-5}}}))
    (root / "benchmark" / "metrics" / "steps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.traced_steps()) or None\n")
    (root / "benchmark" / "metrics" / "data_wait_ms.py").write_text(
        NEW_METRIC)
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [
        {"name": "mtl-step-small", "config": "egopack-mtl-ar-lta-pnr",
         "traffic": "device_pool_small", "chips": 1, "why": "a test cell"}]
    new["per_layer"] = bench["per_layer"] + [
        {"name": "steps_traced", "unit": "steps", "better": "higher",
         "source": "device_trace", "layer": "step", "moves": "clips_per_s",
         "workloads": ["mtl-step-small"]},
        {"name": "data_wait_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "loaders", "moves": "clips_per_s",
         "workloads": ["mtl-step-small"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    m = Manifest(root)
    cell = m.cell("mtl-step-small")
    assert m.traffic(cell["traffic"])["groups"] == 8
    # the metrics that list no cells read in the new one too, with no edit
    every = [x["name"] for x in bench["per_layer"] if "workloads" not in x]
    assert "matmul_device_ms_per_step" in every
    assert [x["name"] for x in m.per_layer("mtl-step-small")] == \
        every + ["steps_traced", "data_wait_ms"]

    out = run_cell(m, "mtl-step-small", 7, 0.2, True, torch.device("cpu"),
                   time.perf_counter(), overrides=TINY, log=lambda line: None)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"steps_traced", "data_wait_ms"}
    assert out["metrics"]["data_wait_ms"]["value"] >= 0.0
    for p, data in before.items():
        assert p.read_bytes() == data
