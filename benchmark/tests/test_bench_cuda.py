"""On the card, at each cell's own size: sound runs of the program pass
every limit, and the control (the reference in TF32) and each fault fail
one. Run with ``python -m pytest benchmark/tests -m cuda`` on a machine
with a card; they skip elsewhere."""

import math

import pytest

from benchmark.harness import cell as cells, check, faults, inputs
from benchmark.tests.tiny import manifest

CELLS = ("mtl-step", "novel-oscc-step", "mtl-loop")
FAULT_CASES = [(c, f) for c in CELLS
               for f in ("unchanged", "half_batch", "few_frozen")] + [
    ("novel-oscc-step", "knn_altered"), ("novel-oscc-step", "knn_duplicate"),
    ("mtl-loop", "gather_shifted")]
SEEDS = (2147483901, 2147483902, 2147483903)


def _setting(cell):
    m = manifest()
    return m.setting(cell) + (m.limits(cell),)


def _program(cfg, traffic, kind, seed, device, fault=None):
    seeds = inputs.stream_seeds(seed)
    try:
        feed, step, rec = cells.program_first_steps(cfg, traffic, kind, seeds,
                                                    device, fault)
    finally:
        faults.restore()
    feed.close()
    del feed, step
    return cells.reference_numbers(cfg, traffic, kind, seeds, device, rec)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(card, cell):
    cfg, traffic, kind, limits = _setting(cell)
    for seed in SEEDS:
        values = cells.control_numbers(cfg, traffic, kind,
                                       inputs.stream_seeds(seed), card)
        ok, checks = check.verdict(values, limits)
        assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_passes(card, cell):
    cfg, traffic, kind, limits = _setting(cell)
    for seed in SEEDS:
        ok, checks = check.verdict(_program(cfg, traffic, kind, seed, card),
                                   limits)
        assert ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_fault_fails_a_limit(card, cell, fault):
    cfg, traffic, kind, limits = _setting(cell)
    values = _program(cfg, traffic, kind, SEEDS[0], card,
                      faults.FAULTS[fault])
    ok, checks = check.verdict(values, limits)
    assert not ok, checks
    assert any(not (math.isfinite(v["value"]) and v["value"] <= v["limit"])
               for v in checks.values())


# a seed on which OSCC's max over a clip's nodes has two values within
# rounding (2.94e-07 of the pooled tensor's root mean square apart, in the
# first step's third aux classifier set), and the program takes the
# runner-up
NODE_TIE_SEED = 4210006024


@pytest.mark.cuda
def test_the_programs_side_of_a_node_tie_is_followed(card):
    cfg, traffic, kind, limits = _setting("novel-oscc-step")
    values = _program(cfg, traffic, kind, NODE_TIE_SEED, card)
    assert values["node_ties_followed"] >= 1
    assert values["node_tie_gap"] < 1e-5
    ok, checks = check.verdict(values, limits)
    assert ok, checks
