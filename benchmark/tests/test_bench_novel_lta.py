"""The cell ``novel-lta-step`` (``configs/egopack-novel-lta.json``,
``limits/novel-lta-step.json``).

On the CPU at tiny widths the real configuration, read through the
manifest, reads correct, and broken underneath reads not correct. On the
card (``cuda``) at its own size, a sound run passes every limit and the
control and each fault fail one."""

import math
import re
import time

import pytest
import torch

from benchmark.harness import cell as cells, check, counts, faults, inputs
from benchmark.harness.cell import run_cell
from benchmark.harness.manifest import Manifest
from benchmark.reference import params as ref_params
from benchmark.tests.test_bench_novel_tasks import published_config
from benchmark.tests.tiny import ROOT, TINY_PHASE2

CELL, CONFIG = "novel-lta-step", "egopack-novel-lta"
CARD = "NVIDIA H100 80GB HBM3"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CUDA_SEED = 2147483917


@pytest.fixture(scope="module")
def manifest():
    return Manifest(ROOT)


def _run(manifest, fault=None, traced=False):
    try:
        return run_cell(manifest, CELL, 17, 0.3, traced, torch.device("cpu"),
                        time.perf_counter(), overrides=TINY_PHASE2,
                        fault=fault, log=lambda line: None)
    finally:
        faults.restore()


def test_the_cell_is_correct_on_the_cpu(manifest):
    out = _run(manifest)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["knn_slack"]["value"] < 1e-6


@pytest.mark.parametrize("fault", ("half_batch", "few_frozen"))
def test_the_cell_broken_is_not_correct(manifest, fault):
    out = _run(manifest, faults.FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_the_configuration_is_the_published_sweeps(manifest):
    """Every setting that ``experiments/egopack/lta.yaml`` gives, on
    ``egopack-novel-oscc``'s sizes, is the file's; the backbone frozen
    keeps 32,871,748 elements in 28 leaves in Adam."""
    cfg = manifest.config(CONFIG)
    want = published_config("lta")
    for key in set(want) - {"name", "source", "about", "assumed"}:
        assert cfg[key] == want[key], key
    assert cfg["source"] == want["source"] and cfg["reduced"] == []
    assert ref_params.trainable_prefixes(cfg) == ("task.lta.", "graphone.")
    assert len(ref_params.trainable_names(cfg)) == 28
    assert ref_params.trainable_elements(cfg) == 32_871_748


def test_the_new_entries_keep_the_manifests_rules(manifest):
    data = manifest.data
    conf = next(c for c in data["configs"] if c["name"] == CONFIG)
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"] == f"benchmark/configs/{CONFIG}.json"
    assert conf["reduced"] == [] and 1 <= len(conf["why"]) <= 200
    assert conf["source"] == manifest.config(CONFIG)["source"]
    w = manifest.cell(CELL)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG,
                                                      "device_pool", 1)
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for name in (CELL, CONFIG):
        assert NAME.match(name)
    limits = manifest.limits(CELL)["limits"]
    # the numbers novel-oscc-step compares, each between its readings
    assert set(limits) == set(manifest.limits("novel-oscc-step")["limits"])
    for spec in limits.values():
        assert spec["lower"] < spec["limit"] < spec["upper"]
    e2e = {m["name"] for m in manifest.end_to_end(CELL)}
    assert {"device_ms_per_step", "setup_s"} <= e2e
    # the per-layer metrics that list no cells, and only those
    unlisted = {m["name"] for m in data["per_layer"] if "workloads" not in m}
    assert unlisted and {m["name"] for m in manifest.per_layer(CELL)} \
        == unlisted


@pytest.mark.parametrize("config,bound", [(CONFIG, "operations"),
                                          ("egopack-novel-oscc", "bytes")])
def test_the_knns_least_time_is_bound_by(manifest, config, bound):
    """LTA's 352 query rows a bank bind the k-NN by its products, OSCC's 64
    by the bytes it reads (``counts.knn_least_s``, which
    ``cosine_knn_roofline`` divides by)."""
    least, binds = counts.knn_least_s(manifest.config(config), CARD)
    assert binds == bound and least > 0


def test_a_traced_cpu_run_reads_only_the_cells_metrics(manifest):
    out = _run(manifest, traced=True)
    assert out["correct"]
    assert set(out["metrics"]) <= {m["name"]
                                   for m in manifest.per_layer(CELL)}


# ---------------- on the card, at the cell's size ----------------

def _program_numbers(card, seed, fault=None):
    cfg, traffic, kind = Manifest(ROOT).setting(CELL)
    seeds = inputs.stream_seeds(seed)
    try:
        feed, step, rec = cells.program_first_steps(cfg, traffic, kind,
                                                    seeds, card, fault)
    finally:
        faults.restore()
    feed.close()
    del feed, step
    return cells.reference_numbers(cfg, traffic, kind, seeds, card, rec)


def _fails(values):
    ok, checks = check.verdict(values, Manifest(ROOT).limits(CELL))
    return not ok and any(
        not (math.isfinite(v["value"]) and v["value"] <= v["limit"])
        for v in checks.values())


@pytest.mark.cuda
def test_sound_run_passes_on_the_card(card):
    values = _program_numbers(card, CUDA_SEED)
    ok, checks = check.verdict(values, Manifest(ROOT).limits(CELL))
    assert ok, checks
    assert values["node_ties_followed"] == 0  # LTA takes no max over nodes


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    cfg, traffic, kind = Manifest(ROOT).setting(CELL)
    assert _fails(cells.control_numbers(cfg, traffic, kind,
                                        inputs.stream_seeds(CUDA_SEED), card))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ("half_batch", "few_frozen", "knn_altered",
                                   "knn_duplicate"))
def test_fault_fails_on_the_card(card, fault):
    assert _fails(_program_numbers(card, CUDA_SEED, faults.FAULTS[fault]))
