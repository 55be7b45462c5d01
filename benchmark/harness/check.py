"""What decides ``correct``: the program's first steps, as the window's own
call and feed take them, held against the plain reference
(``benchmark/reference``) run afterwards on the same inputs.

Set-up builds the one step object the window uses and drives it through
its first ``STEPS`` steps on distinct batch groups; :class:`Record` keeps
what those steps produced. After the window, with the program freed, the
reference starts from the same weights and takes the same steps on the
same batches with the same dropout masks (drawn from the same seed in the
same order). The numbers it reads (``limits/<cell>.json`` names those a
cell compares, each with its limit):

- ``loss_gap``: the worst, over the steps, of the gap between the
  program's loss and the reference's, over the reference's;
- ``grad_gap``: the first gradient as Adam receives it (the program's read
  back from its first moment after one step: ``m / (1 - b1)``), by the
  worst leaf: the gap between the two sides' norms of the leaf, over the
  larger of the reference's norm of that leaf and of the median leaf;
  ``grad_gap_median``: the median leaf's gap; ``grad_norm_gap``: the gap
  of the norms over all the trainable leaves at once;
- ``grad_elem_off``: the share of the first gradient's elements, over all
  the trainable leaves, that differ from the reference's by more than a
  hundredth of the root mean square of the reference's leaf;
- ``change_gap`` and ``change_gap_median``: the same of each leaf's change
  over the ``STEPS`` steps, taken before the next step moves it; leaves
  whose reference gradient is under a thousandth of the median leaf's are
  left out (``quiet_leaves`` counts them);
- phase 2 also ``knn_slack`` and ``knn_dist_gap`` (``KnnJudge``): the
  program's neighbour lists against the reference's distances;
- where the loss pools OSCC over a clip's nodes (phase 1 with OSCC among
  the tasks, phase 2 with OSCC the novel task), ``node_ties_followed`` and
  ``node_tie_gap`` (``NodeMax``, not compared): how many ties of that max
  the reference took the program's way over the steps, and the widest of
  their gaps; each step's gradient, read back from the program's first
  moments, shows which way it took them;
- ``batch_gap``: the worst gap, element by element, between the batch
  groups the program's feed handed its first steps and those the reference
  made for itself (``reference_groups`` of the feed kind); ``inf`` where
  their tasks, keys or shapes differ.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..reference import model as ref
from ..reference import params as ref_params

STEPS = 3
QUIET_GRAD = 1e-3  # under this share of the median leaf's gradient


@dataclass
class Record:
    """What the program's first steps produced."""
    names: List[str]
    losses: List[float] = field(default_factory=list)
    first_grad: Dict[str, float] = field(default_factory=dict)
    change: Dict[str, float] = field(default_factory=dict)
    grad: Dict[str, torch.Tensor] = field(default_factory=dict)
    knn: list = field(default_factory=list)
    groups: list = field(default_factory=list)
    grads: list = field(default_factory=list)


def record_first_steps(step, feed, start_knn: Optional[Callable] = None,
                       all_grads: bool = False) -> Record:
    """Drive ``step`` through its first ``STEPS`` calls on the feed's next
    groups and keep the losses, the first gradient's leaf norms, each
    leaf's change, (with ``start_knn``) the k-NN's outputs and (with
    ``all_grads``) each step's gradient as Adam got it, read back from the
    first moments on the host: ``(m_t - b1 m_{t-1}) / (1 - b1)``."""
    names = step.trainable_names()
    params = step.system.params()
    start = {n: params[n].detach().clone() for n in names}
    stop_knn = start_knn() if start_knn else None
    rec = Record(names)
    losses, grad, moments = [], None, []
    b1 = step.optimizer.b1
    for i in range(STEPS):
        batches, _ = feed.next()
        rec.groups.append({t: {k: v.detach().cpu() for k, v in b.items()}
                           for t, b in batches.items()})
        losses.append(step.total_loss(step(batches)).detach())
        if i == 0:
            first = {n: step.opt_state.mu[n].float() / (1.0 - b1)
                     for n in names}
            grad = torch.stack([first[n].double().norm() for n in names])
            rec.grad = {n: g.cpu() for n, g in first.items()}
            del first
        if all_grads:
            moments.append({n: step.opt_state.mu[n].to(
                "cpu", torch.float32, copy=True) for n in names})
    if moments:
        rec.grads = [rec.grad] + [
            {n: (m[n] - b1 * prev[n]) / (1.0 - b1) for n in names}
            for prev, m in zip(moments, moments[1:])]
    change = torch.stack([(params[n].detach() - start[n]).double().norm()
                          for n in names])
    if stop_knn is not None:
        rec.knn = [(i.cpu(), d.cpu()) for i, d in stop_knn()]
    rec.losses = [float(v) for v in torch.stack(losses).cpu()]
    rec.first_grad = dict(zip(names, grad.cpu().tolist()))
    rec.change = dict(zip(names, change.cpu().tolist()))
    return rec


def reference_steps(cfg: dict, params, batch_groups, dropout_gen,
                    banks=None, knn_seen=None,
                    knn_dtype=torch.float64, follow=(),
                    keep_grads: bool = False) -> ref.ReferenceRun:
    """The reference's first ``STEPS`` steps, following the program's
    k-NN lists (``knn_seen``) and its side of each tie of a max over
    nodes (``follow``: its gradients, a step)."""
    knn = (ref.KnnJudge(cfg["graphone"]["k"], knn_dtype, seen=knn_seen)
           if cfg["phase"] == 2 else None)
    run = ref.ReferenceRun(cfg, params, ref_params.trainable_names(cfg),
                           banks=banks, knn=knn, follow=follow,
                           keep_grads=keep_grads)
    run.groups = list(batch_groups[:STEPS])
    for batches in run.groups:
        run.step(batches, dropout_gen)
    return run


def _leaf_gaps(prog: Dict[str, float], want: Dict[str, float],
               names: List[str]) -> List[float]:
    """Each leaf's gap of norms, over the larger of the reference's norm
    of that leaf and of the median leaf."""
    med = statistics.median(want[n] for n in names)
    gaps = []
    for n in names:
        gap = abs(prog[n] - want[n]) / max(want[n], med)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def _whole_gap(prog: Dict[str, float], want: Dict[str, float],
               names: List[str]) -> float:
    """The gap of the norms over every leaf at once, over the reference's
    norm (each side's whole norm from its leaves' norms)."""
    p = math.sqrt(sum(prog[n] ** 2 for n in names))
    w = math.sqrt(sum(want[n] ** 2 for n in names))
    gap = abs(p - w) / w
    return gap if math.isfinite(gap) else math.inf


def _batch_gap(prog: list, want: list) -> float:
    if len(prog) != len(want):
        return math.inf
    worst = 0.0
    for p, w in zip(prog, want):
        if set(p) != set(w):
            return math.inf
        for task, batch in w.items():
            if set(p[task]) != set(batch):
                return math.inf
            for key, ref_value in batch.items():
                a, b = p[task][key], ref_value.cpu()
                if a.shape != b.shape:
                    return math.inf
                if a.numel():
                    worst = max(worst, float((a.double() - b.double())
                                             .abs().max()))
    return worst


def worst_leaves(rec: Record, run: ref.ReferenceRun, top: int = 5
                 ) -> Dict[str, list]:
    """The leaves behind ``grad_gap`` and ``change_gap``, worst first:
    ``[name, gap, program's norm, reference's norm]``."""
    out = {}
    change = run.change()
    for key, prog, want in (("grad", rec.first_grad, run.first_grad),
                            ("change", rec.change, change)):
        med = statistics.median(want.values())
        rows = [[n, abs(prog[n] - want[n]) / max(want[n], med), prog[n],
                 want[n]] for n in run.names]
        rows.sort(key=lambda r: -r[1])
        out[key] = rows[:top] + [["median", med]]
    return out


def numbers(cfg: dict, rec: Record, run: ref.ReferenceRun
            ) -> Dict[str, float]:
    """The numbers compared, from the program's record and the
    reference's run."""
    if sorted(rec.names) != sorted(run.names):
        return {"trainable_mismatch": 1.0}
    out = {"loss_gap": max(abs(p - r) / abs(r) if math.isfinite(p)
                           else math.inf
                           for p, r in zip(rec.losses, run.losses))}
    out["grad_norm_gap"] = _whole_gap(rec.first_grad, run.first_grad,
                                      run.names)
    grad = _leaf_gaps(rec.first_grad, run.first_grad, run.names)
    out["grad_gap"] = max(grad)
    out["grad_gap_median"] = statistics.median(grad)
    out["grad_elem_off"] = ref.elements_off(rec.grad, run.first_grad_tensors,
                                            run.names)
    taken = [t for step in run.followed for t in step]
    out["node_ties_followed"] = float(len(taken))
    out["node_tie_gap"] = max((t[0] for t in taken), default=0.0)
    plain = run.first_plain_grad
    med = statistics.median(plain.values())
    moved = [n for n in run.names if plain[n] >= QUIET_GRAD * med]
    out["quiet_leaves"] = float(len(run.names) - len(moved))
    change = _leaf_gaps(rec.change, run.change(), moved)
    out["change_gap"] = max(change)
    out["change_gap_median"] = statistics.median(change)
    if run.knn is not None:
        out["knn_slack"] = run.knn.slack
        out["knn_dist_gap"] = run.knn.dist_gap
    out["batch_gap"] = _batch_gap(rec.groups, run.groups)
    return out


def verdict(values: Dict[str, float], limits: Dict[str, dict]
            ) -> Tuple[bool, Dict[str, dict]]:
    """Each number compared beside its limit; correct when every one is
    finite and at most its limit. A program whose trainable leaves are not
    the configuration's is not correct whatever it reads."""
    checks, ok = {}, "trainable_mismatch" not in values
    if not ok:
        checks["trainable_mismatch"] = {"value": 1.0, "limit": 0.0}
    for name, spec in limits["limits"].items():
        v = values.get(name, math.inf)
        checks[name] = {"value": v, "limit": spec["limit"]}
        ok &= math.isfinite(v) and v <= spec["limit"]
    return ok, checks
