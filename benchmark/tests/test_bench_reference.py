"""The reference against the program at tiny widths on the CPU, every
cell, through the whole of a run but the look for a card; and the same
run with the timed path broken underneath, which has to come out not
correct."""

import math

import pytest

from benchmark.harness import faults
from benchmark.tests.test_bench_cuda import CELLS, FAULT_CASES
from benchmark.tests.tiny import manifest, run_tiny


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_the_reference(cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    checks = out["checks"]
    assert checks["loss_gap"]["value"] < 1e-5
    assert checks["grad_elem_off"]["value"] < 1e-3
    # the CPU has no device trace: the card's busy time does not read
    assert set(out["metrics"]) == {
        m["name"] for m in manifest().end_to_end(cell)} - {
        "device_ms_per_step"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_broken_step_is_not_correct(cell, fault):
    try:
        out = run_tiny(cell, fault=faults.FAULTS[fault])
    finally:
        faults.restore()
    assert not out["correct"]
    failing = [k for k, v in out["checks"].items()
               if not (math.isfinite(v["value"])
                       and v["value"] <= v["limit"])]
    assert failing


# metrics that a replayed step left with nothing to read, or reading the
# capture call rather than the step, and so retired
RETIRED = {f"{p}_{m}" for p in ("forward", "backward", "norms")
           for m in ("launches_per_step", "host_ms")}


def test_traced_run_reports_per_layer_metrics():
    out = run_tiny("novel-oscc-step", traced=True, seconds=0.2)
    assert out["correct"]
    # the CPU has no device trace: only the window's clocks read
    assert set(out["metrics"]) == {"host_ms_per_step", "window_step_ms_p95"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    m = manifest()
    for cell in CELLS:
        names = {x["name"] for x in m.per_layer(cell)}
        assert not names & RETIRED
        # read by kernel name in every cell, a later one included
        assert "matmul_device_ms_per_step" in names
    assert not any((m.bench_dir / "metrics" / f"{n}.py").exists()
                   for n in RETIRED)


def test_dropout_masks_are_the_programs():
    """The reference draws the program's masks: with another dropout seed
    the two sides part."""
    import torch
    from benchmark.harness import cell as cells, inputs
    from benchmark.harness.manifest import Manifest
    from benchmark.tests.tiny import TINY
    cfg, traffic, kind = Manifest().setting("mtl-step")
    cfg = {**cfg, **TINY}
    seeds = inputs.stream_seeds(3)
    dev = torch.device("cpu")
    _, _, rec = cells.program_first_steps(cfg, traffic, kind, seeds, dev)
    same = cells.reference_numbers(cfg, traffic, kind, seeds, dev, rec)
    other = cells.reference_numbers(
        cfg, traffic, kind, {**seeds, "dropout": seeds["dropout"] + 1}, dev,
        rec)
    assert same["loss_gap"] < 1e-5 < other["loss_gap"]
