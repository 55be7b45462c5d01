"""OSCC's max over a clip's nodes where its two largest values lie within
rounding: the reference takes the node that the program's gradient shows
it took (``reference/model.py:NodeMax``), in phase 2 with OSCC the novel
task and in a phase-1 task set with OSCC, at tiny widths on the CPU."""

import math

import torch

from benchmark.harness import cell as cells, check, inputs
from benchmark.reference import model as ref
from benchmark.reference import params
from benchmark.tests.tiny import OVERRIDES, manifest

SEED = 2147483777


# the cell each case runs in, and what it changes in that cell's
# configuration: phase 2 with novel OSCC, and a phase-1 task set with OSCC
CASES = {"novel-oscc-step": ("novel-oscc-step", {}),
         "phase-1 ar-oscc-lta": ("mtl-step",
                                 {"tasks": ["ar", "oscc", "lta"]})}


def _inputs(case="novel-oscc-step"):
    cell, change = CASES[case]
    cfg, traffic, kind = manifest().setting(cell)
    cfg = {**cfg, **OVERRIDES[cell], **change}
    dev = torch.device("cpu")
    seeds = inputs.stream_seeds(SEED)
    weights = params.init_params(cfg, inputs.generator(seeds["weights"], dev),
                                 dev)
    groups = kind.reference_groups(cfg, traffic, seeds["batches"], dev,
                                   check.STEPS)
    banks = (inputs.banks(cfg, seeds["banks"], dev) if cfg["phase"] == 2
             else None)
    return cfg, weights, groups, banks, lambda: inputs.generator(
        seeds["dropout"], dev)


def _knn(cfg):
    return ref.KnnJudge(cfg["graphone"]["k"]) if cfg["phase"] == 2 else None


def _steps(cfg, weights, groups, banks, gen, follow=(), flip=None):
    """The reference's steps; with ``flip`` it stands for a program that
    takes the runner-up node at that tie of its first step."""
    run = ref.ReferenceRun(cfg, weights, params.trainable_names(cfg),
                           banks=banks, knn=_knn(cfg), follow=follow,
                           keep_grads=True)
    if flip is not None:
        start = run.node_max.start
        run.node_max.start = lambda flips: start(
            set(flips) | ({flip} if not run.losses else set()))
    g = gen()
    for batches in groups:
        run.step(batches, g)
    return run


def test_every_feature_pooled_is_a_tie_under_an_endless_slack():
    pool = ref.NodeMax(math.inf, 2)
    feat = torch.randn(3, 4, 5)
    out = pool.pool(feat)
    assert torch.equal(out, feat.amax(1))
    assert len(pool.ties) == 15
    assert len(pool.choices()) == 4  # none, each of two, both


def test_a_flip_takes_the_runner_up_node_and_its_gradient():
    feat = torch.tensor([[[1.0, 5.0], [3.0, 4.0], [2.0, 6.0]]],
                        requires_grad=True)
    pool = ref.NodeMax(math.inf, 4)
    pool.start({(0, 0, 1)})
    out = pool.pool(feat)
    assert out.tolist() == [[3.0, 5.0]]
    out.sum().backward()
    assert feat.grad.tolist() == [[[0.0, 1.0], [1.0, 0.0], [0.0, 0.0]]]


def _follow_a_planted_tie(monkeypatch, case):
    monkeypatch.setattr(ref, "NODE_TIE_SLACK", math.inf)
    cfg, weights, groups, banks, gen = _inputs(case)
    probe = ref.ReferenceRun(cfg, weights, params.trainable_names(cfg),
                             banks=banks, knn=_knn(cfg))
    probe._pass(groups[0], gen())
    plain = _steps(cfg, weights, groups, banks, gen)
    names = plain.names
    # the closest tie whose two sides differ (where the head's dropout
    # keeps the pooled feature): both sound, and far apart by elements
    for gap, *tie in sorted(probe.node_max.ties)[:16]:
        tie = tuple(tie)
        program = _steps(cfg, weights, groups, banks, gen, flip=tie)
        if ref.elements_off(program.first_grad_tensors,
                            plain.first_grad_tensors, names) > 1e-3:
            break
    else:
        raise AssertionError("no tie of the first step moves the gradient")
    judged = _steps(cfg, weights, groups, banks, gen,
                    follow=program.step_grads)
    assert judged.followed[0] == [(gap, *tie)]
    assert judged.followed[1:] == [[], []]
    assert ref.elements_off(program.first_grad_tensors,
                            judged.first_grad_tensors, names) == 0.0
    assert judged.losses == program.losses


def test_the_reference_follows_the_programs_side_of_a_tie(monkeypatch):
    _follow_a_planted_tie(monkeypatch, "novel-oscc-step")


def test_the_reference_follows_the_programs_side_of_a_phase1_tie(monkeypatch):
    """Phase 1 with OSCC among the tasks pools OSCC's nodes by a max too."""
    _follow_a_planted_tie(monkeypatch, "phase-1 ar-oscc-lta")


def test_without_ties_the_reference_reads_as_it_did(monkeypatch):
    monkeypatch.setattr(ref, "NODE_TIE_SLACK", 0.0)
    cfg, weights, groups, banks, gen = _inputs()
    plain = _steps(cfg, weights, groups, banks, gen)
    judged = _steps(cfg, weights, groups, banks, gen,
                    follow=plain.step_grads)
    assert judged.followed == [[], [], []]
    assert judged.losses == plain.losses


def test_a_run_reads_the_programs_gradient_at_every_step():
    cfg, traffic, kind = manifest().setting("novel-oscc-step")
    cfg = {**cfg, **OVERRIDES["novel-oscc-step"]}
    dev = torch.device("cpu")
    seeds = inputs.stream_seeds(SEED)
    feed, step, rec = cells.program_first_steps(cfg, traffic, kind, seeds,
                                                dev)
    feed.close()
    assert len(rec.grads) == check.STEPS
    run = cells.reference_run(cfg, traffic, kind, seeds, dev, rec.knn,
                              keep_grads=True)
    for mine, want in zip(rec.grads, run.step_grads):
        assert ref.elements_off(mine, want, run.names) < 1e-3
    values = check.numbers(cfg, rec, cells.reference_run(
        cfg, traffic, kind, seeds, dev, rec.knn, follow=rec.grads))
    assert values["node_ties_followed"] == 0.0
    assert values["grad_elem_off"] < 1e-3
