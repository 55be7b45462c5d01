"""The frozen counts against hand counts, and against the program's own
count where the two should agree."""

import pytest

from benchmark.harness import counts
from benchmark.harness.manifest import Manifest
from benchmark.reference import params
from benchmark.tests.test_bench_phase1_sets import SETS
from benchmark.tests.tiny import ROOT

CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def cfgs():
    m = Manifest(ROOT)
    return (m.config("egopack-mtl-ar-lta-pnr"),
            m.config("egopack-novel-oscc"))


def test_linear_by_hand():
    assert counts.linear(2, 3, 4, train=False) == 48
    assert counts.linear(2, 3, 4, input_grad=False) == 96
    assert counts.linear(2, 3, 4) == 144


def test_phase1_by_hand_at_a_small_size(cfgs):
    """One task, batch 2, 3 nodes, 2 segments of 4, hidden 5, depth 1,
    concat layout, 2 verbs and 3 nouns."""
    cfg = {**cfgs[0], "tasks": ["ar"], "nodes": {"ar": 3}, "batch_size": 2,
           "num_segments": 2, "feature_dim": 4, "hidden_size": 5,
           "tp_hidden_size": 5, "depth": 1, "n_verbs": 2, "n_nouns": 3}
    r, h = 6, 5
    pool = 2 * 2 * r * 8 * h + 3 * 2 * r * h * h * 2
    sage = 3 * 3 * 2 * r * h * h + 2 * (2 * r * r * h)
    out_lin = 3 * 2 * r * h * h
    heads = 2 * 3 * 2 * r * h * h + 3 * 2 * r * h * 2 + 3 * 2 * r * h * 3
    assert counts.phase1_step_flops(cfg) == pool + sage + out_lin + heads


def test_phase1_matches_the_program_at_full_width(cfgs):
    from egopack_torch import flops
    cfg = cfgs[0]
    assert counts.step_flops(cfg) == flops.mtl_step_flops(16, 1536, 1024)
    assert counts.step_flops(cfg) == 89_187_581_952


@pytest.mark.parametrize("tasks", SETS, ids="-".join)
def test_every_published_task_set_matches_the_program(cfgs, tasks):
    """Each task set of ``experiments/mtl.yaml`` at full width, OSCC's
    classifier on the pool of each clip's nodes."""
    from egopack_torch import flops
    cfg = {**cfgs[0], "tasks": list(tasks)}
    assert counts.step_flops(cfg) == flops.mtl_step_flops(16, 1536, 1024,
                                                          active=tasks)


def test_phase2_matches_the_program_at_full_width(cfgs):
    """The published settings (k=4, residual, the backbone in train mode)
    change no product, so the count is the program's."""
    from egopack_torch import flops
    cfg = cfgs[1]
    assert counts.step_flops(cfg) == flops.egopack_step_flops(16, 1536, 1024,
                                                              2048)


def test_phase2_by_hand_for_a_frozen_backbone_and_node_classifiers(cfgs):
    """Novel LTA at a small size: batch 2, 3 nodes, 2 segments of 4, hidden
    5, depth 1, two aux banks of 7 rows, GraphONE depth 1 of width 6, 2
    verbs and 3 nouns; the backbone frozen, so its forward alone and no
    gradient into the features."""
    cfg = {**cfgs[1], "tasks": ["lta"], "aux_tasks": ["ar", "pnr"],
           "nodes": {"lta": 3}, "batch_size": 2, "num_segments": 2,
           "feature_dim": 4, "hidden_size": 5, "tp_hidden_size": 5,
           "depth": 1, "n_verbs": 2, "n_nouns": 3,
           "backprop_temporal_graph": False, "banks": {"rows": 7},
           "graphone": {**cfgs[1]["graphone"], "depth": 1,
                        "hidden_size": 6}}
    r, h = 6, 5
    backbone = (2 * r * 8 * h + 2 * 2 * r * h * h + 3 * 2 * r * h * h
                + 2 * r * 3 * h + 2 * r * h * h)  # the aggregation once
    projection = 2 * 2 * r * h * h + 3 * 2 * r * h * h  # no input gradient
    aux = 2 * 2 * (2 * r * h * h)
    knn = 2 * 2 * r * 7 * h
    stage = 2 * 2 * r * h * 6
    graphone = 3 * stage + 4 * stage
    classifiers = 3 * (3 * 2 * r * h * 2 + 3 * 2 * r * h * 3)
    assert counts.phase2_step_flops(cfg) == (backbone + projection + aux
                                             + knn + graphone + classifiers)
    assert counts.knn_least_s({**cfg, "banks": {"rows": 7, "valid": 7}},
                              CARD)[0] == pytest.approx(
        counts.knn_counts(2, r, 7, 7, h, cfg["graphone"]["k"])[0] / 3.35e12)


def test_trainable_elements(cfgs):
    assert params.trainable_elements(cfgs[0]) == 24_842_403
    names = params.trainable_names(cfgs[1])
    assert all(n.startswith(("temporal_graph.", "task.oscc.", "graphone."))
               for n in names)
    assert len(names) == 53


def test_adam_roofline_counts():
    assert counts.adam_bytes(10) == 280
    assert counts.adam_bytes(10, "bfloat16") == 200
    least = counts.adam_least_s(24_842_403, "float32", CARD)
    assert least == pytest.approx(28 * 24_842_403 / 3.35e12)
    assert least == pytest.approx(0.2076379952238806e-3)


def test_knn_roofline_counts(cfgs):
    nbytes, ops = counts.knn_counts(3, 64, 2010, 2048, 1024, 4)
    assert nbytes == 3 * 2010 * 1024 * 4 + 3 * 64 * 1024 * 4 + 3 * 2048 \
        + 3 * 64 * 4 * 8
    assert ops == 2 * 3 * 64 * 2010 * 1024
    least, bound = counts.knn_least_s(cfgs[1], CARD)
    assert bound == "bytes" and least == pytest.approx(nbytes / 3.35e12)


def test_peaks_and_union():
    assert counts.bf16_peak(CARD) == 989.4e12
    assert counts.tf32_peak(CARD) == 495e12
    assert counts.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    with pytest.raises(RuntimeError):
        counts.bf16_peak("NVIDIA A100")
