"""Plain PyTorch reference of the EgoPack training steps that the benchmark
times: the phase-1 multi-task step of any task set (``cfg["tasks"]``, as
``experiments/mtl.yaml`` trains them) and the phase-2 EgoPack step of any
novel task (AR, LTA, OSCC or PNR, ``cfg["tasks"][0]``), each with its
losses, backward pass and Adam update.

It follows the published model (sapeirone/EgoPack: ``models/graph.py``,
``models/temporal_pooling/trn_pooling.py``, ``models/tasks/*.py``,
``models/graphONE.py``, ``main_temporal.py``, ``main_egopack.py``) in the
most direct form: each task's graph on its own, mean aggregation as a
product with the row-normalised adjacency, the cosine k-NN by a full
distance matrix and a stable sort, and ``torch.optim.Adam`` (coupled L2
weight decay). It imports nothing but ``torch`` and ``numpy``.

Parameters are a ``{name: tensor}`` dict under the names of
:func:`benchmark.reference.params.param_spec`. Dropout masks are U[0, 1)
draws from the generator the caller hands over, at the shapes and in the
order the published modules apply dropout: phase 1, the TRN pooling's two
dropouts over every task's nodes at once (``(1, rows, hidden)`` each, the
tasks in the config's order); phase 2, the pooling's two over the novel
task's nodes (in train mode only), then the novel head's classifiers, one
draw each (verb then noun for AR and LTA), over its features (OSCC's
max-pooled over the nodes), then each aux task's classifier set in the
order of ``aux_tasks`` over its interacted features. A kept entry is
scaled by ``1 / keep``.

Where it departs from the published modules, it does as the program and
the JAX package do:

- the dropout masks are the draws above, not torch's own dropout stream,
  which no second program can repeat;
- GraphONE's k-NN edges come from the aux features as they enter it and
  stay fixed over its stages, where the published loop takes them again
  at each stage (SURVEY.md section 3.3);
- a per-node loss (AR, LTA, PNR) is the mean over every node of the batch:
  a node labelled -1 reads 0 and stays in the count, as the program's
  ``masked_mean`` takes it; OSCC's, a loss a clip, the mean over the
  batch's clips;
- the k-NN judge continues with the program's lists once it has judged
  them (:class:`KnnJudge`);
- where OSCC's max over a clip's nodes has its two largest values within
  rounding of each other, the reference takes whichever node the
  program's gradient shows it took (:class:`NodeMax`).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


# ---------------- layers ----------------

def _dropout(x: torch.Tensor, rate: float,
             gen: Optional[torch.Generator]) -> torch.Tensor:
    if rate == 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < keep, x / keep, 0.0)


def _linear(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def _layer_norm(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"],
                        P[f"{name}.bias"], 1e-5)


def _graph_layer_norm(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """PyG ``LayerNorm(mode='graph')`` without a batch vector: one mean and
    one (biased) std over the whole node tensor, eps added to the std."""
    mean = x.mean()
    std = ((x - mean) ** 2).mean().sqrt()
    return (x - mean) / (std + 1e-5) * P[f"{name}.weight"] + P[f"{name}.bias"]


def positional_encoding(pos: torch.Tensor, channels: int) -> torch.Tensor:
    """PyG ``PositionalEncoding`` (base frequency 1e-4)."""
    half = channels // 2
    freqs = 1e-4 ** torch.linspace(0.0, 1.0, half, device=pos.device)
    ang = pos.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ---------------- graphs ----------------

def chain_adjacency(n: int, radius: float) -> np.ndarray:
    """``radius_graph`` over positions 0..n-1 without self loops:
    ``A[t, s]`` is True where node s sends to node t."""
    pos = np.arange(n)
    d = np.abs(pos[:, None] - pos[None, :])
    return (d <= radius) & (d > 0)


def lta_adjacency(y_verb: np.ndarray, n: int, radius: float) -> np.ndarray:
    """Per-sample LTA graph (``lta_temp_connectivity.py``): the chain plus
    edges from the last ``floor(radius)`` input clips to every forecast
    clip, where inputs are the ``-1`` labels and forecasts are counted by
    ``verb > 0``. Returns ``(B, n, n)``."""
    out = np.repeat(chain_adjacency(n, radius)[None], len(y_verb), 0)
    for b, verbs in enumerate(y_verb):
        ni, nf = int((verbs == -1).sum()), int((verbs > 0).sum())
        lo = max(math.ceil(ni - radius), 0)
        out[b, ni:min(ni + nf, n), lo:ni] = True
    return out


def task_graph(cfg: dict, task: str, y: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(adjacency (B, N, N) float, positions (N,)) of one task's batch."""
    n = cfg["nodes"][task]
    radius = cfg["graph_k"] + 0.5
    if task == "lta":
        adj = lta_adjacency(y[..., 0].cpu().numpy(), n, radius)
    else:
        adj = np.repeat(chain_adjacency(n, radius)[None], y.shape[0], 0)
    pos = np.arange(n, dtype=np.float32)
    if task == "ar":
        pos = pos - n // 2
    dev = y.device
    return (torch.as_tensor(adj, device=dev).float(),
            torch.as_tensor(pos, device=dev))


def expand_nodes(cfg: dict, task: str, x: torch.Tensor) -> torch.Tensor:
    """The loader's compact layouts to ``(B, N, S, D)``: PNR ships one
    frame a node (repeated over the segments), LTA its input clips (the
    forecast nodes are their mean)."""
    s, n = cfg["num_segments"], cfg["nodes"][task]
    if x.ndim == 3:
        x = x[:, :, None, :].expand(-1, -1, s, -1)
    if x.shape[1] != n:
        fill = x.mean(1, keepdim=True).expand(-1, n - x.shape[1], -1, -1)
        x = torch.cat([x, fill], 1)
    return x


# ---------------- backbone ----------------

def trn_pooling(P: Params, cfg: dict, x: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
    """Segments to node (``trn_pooling.py``): (..., S, D) -> (..., H)."""
    p = "temporal_graph.pooling"
    rate = cfg["tp_dropout"] if gen is not None else 0.0
    h = x.reshape(*x.shape[:-2], -1)
    h = _dropout(torch.relu(_layer_norm(P, f"{p}.ln0", _linear(P, f"{p}.fc0",
                                                               h))), rate, gen)
    h = _dropout(torch.relu(_layer_norm(P, f"{p}.ln1", _linear(P, f"{p}.fc1",
                                                               h))), rate, gen)
    return _linear(P, f"{p}.fc_out", h)


def sage(P: Params, name: str, x: torch.Tensor,
         adj: torch.Tensor) -> torch.Tensor:
    """``SAGEConv(project=True)``, mean aggregation over in-neighbours."""
    msg = torch.relu(_linear(P, f"{name}.lin_project", x))
    deg = adj.sum(-1, keepdim=True).clamp_min(1.0)
    agg = (adj @ msg) / deg
    return _linear(P, f"{name}.lin_l", agg) + _linear(P, f"{name}.lin_r", x)


def reason(P: Params, cfg: dict, h: torch.Tensor, adj: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    """``Graph``: ``h + out_lin(net(h + PE(pos)))``, net = depth x
    [SAGE -> graph LayerNorm -> LeakyReLU(0.2)]."""
    z = h + positional_encoding(pos, h.shape[-1])[None]
    for i in range(cfg["depth"]):
        z = sage(P, f"temporal_graph.sage{i}", z, adj)
        z = F.leaky_relu(_graph_layer_norm(P, f"temporal_graph.gn{i}", z),
                         0.2)
    return h + _linear(P, "temporal_graph.out_lin", z)


def project(P: Params, head: str, x: torch.Tensor) -> torch.Tensor:
    """A task's projection MLP: Linear -> LayerNorm -> ReLU -> Linear."""
    h = torch.relu(_layer_norm(P, f"task.{head}.proj_ln",
                               _linear(P, f"task.{head}.proj_fc0", x)))
    return _linear(P, f"task.{head}.proj_fc1", h)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Per element, label -1 ignored (it reads 0 and stays in the mean)."""
    flat = logits.reshape(-1, logits.shape[-1])
    out = F.cross_entropy(flat, labels.reshape(-1).long(), ignore_index=-1,
                          reduction="none", label_smoothing=smoothing)
    return out.reshape(labels.shape)


HEADS = {"ar": "recognition", "lta": "lta", "pnr": "pnr", "oscc": "oscc"}


# ---------------- phase 1 ----------------

def phase1_losses(P: Params, cfg: dict, batches: Dict[str, Batch],
                  gen: Optional[torch.Generator],
                  node_max: Optional[NodeMax] = None
                  ) -> Dict[str, torch.Tensor]:
    """Each task's mean loss (``main_temporal.py``): AR and LTA the sum of
    the verb and noun cross entropies per node, PNR the binary cross
    entropy per node, each averaged over every node of the batch; OSCC the
    plain cross entropy (no label smoothing: that is phase 2's) of each
    clip's nodes max-pooled (by ``node_max`` where given) and classified,
    averaged over the batch's clips."""
    tasks = cfg["tasks"]
    xs = [expand_nodes(cfg, t, batches[t]["x"]) for t in tasks]
    sizes = [x.shape[:2] for x in xs]
    # the pooling MLP is per node: every task's nodes in one pass, so the
    # dropout masks cover them all at once
    rows = torch.cat([x.reshape(-1, *x.shape[2:]) for x in xs])
    pooled = trn_pooling(P, cfg, rows[None], gen)[0]
    out, off = {}, 0
    for t, (b, n) in zip(tasks, sizes):
        h = pooled[off:off + b * n].reshape(b, n, -1)
        off += b * n
        y = batches[t]["y"]
        adj, pos = task_graph(cfg, t, y)
        feat = project(P, HEADS[t], reason(P, cfg, h, adj, pos))
        head = f"task.{HEADS[t]}"
        if t in ("ar", "lta"):
            per = sum(cross_entropy(_linear(P, f"{head}.cls{i}.TLinear_0",
                                            feat), y[..., i])
                      for i in range(2))
        elif t == "oscc":
            clip = feat.amax(1) if node_max is None else node_max.pool(feat)
            per = cross_entropy(_linear(P, f"{head}.cls.TLinear_0", clip), y)
        elif t == "pnr":
            logit = _linear(P, f"{head}.cls.TLinear_0", feat)[..., 0]
            per = F.binary_cross_entropy_with_logits(logit, y.float(),
                                                     reduction="none")
        else:
            raise ValueError(f"no phase-1 loss for task {t!r}")
        out[t] = per.mean()
    return out


# ---------------- phase 2 ----------------

def cosine_topk(features: torch.Tensor, bank: torch.Tensor, mask: torch.Tensor,
                k: int, dtype: torch.dtype = torch.float64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid bank rows by cosine distance ``1 - f̂·b̂``, ordered
    by (distance, index): ``(indices (M, k), distances (M, k))``; also
    returns the whole distance matrix as a third value."""
    f = F.normalize(features.to(dtype), dim=-1)
    b = F.normalize(bank.to(dtype), dim=-1)
    d = 1.0 - f @ b.t()
    d = torch.where(mask[None, :], d, torch.inf)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return idx[:, :k], dist[:, :k], d


def graphone(P: Params, cfg: dict, feats: Dict[str, torch.Tensor],
             banks: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
             neighbours: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``GraphONE`` (``graphONE.py``): each aux task's features (M, F)
    meet its k nearest prototypes; ``depth`` stages of SAGE with max
    aggregation over ``max(k prototypes, the node itself)``, LayerNorm,
    ReLU and a projection, with a residual. The k-NN edges come from the
    original features and stay fixed over the stages."""
    g = cfg["graphone"]
    out = {}
    for ti, t in enumerate(cfg["aux_tasks"]):
        bank = banks[t][0]
        nb_max = bank[neighbours[t].long()].amax(1)          # (M, F)
        cur = feats[t]
        for d in range(g["depth"]):
            agg = torch.maximum(nb_max, cur)
            h = agg @ P["graphone.w_l"][d, ti] + cur @ P["graphone.w_r"][d, ti]
            h = F.layer_norm(h, (h.shape[-1],), P["graphone.ln_scale"][d, ti],
                             P["graphone.ln_bias"][d, ti], 1e-5)
            o = torch.relu(h) @ P["graphone.w_proj"][d, ti] \
                + P["graphone.b_proj"][d, ti]
            cur = o + cur if g["residual"] else o
        out[t] = cur
    return out


class NodeMax:
    """OSCC's max over each clip's nodes, and which node takes the gradient
    where the two largest values lie within rounding of each other.

    Which of two nodes that close a program takes is decided by the
    rounding of its products, and either is sound; but the gradient goes
    to that node alone, and through it to whole rows of the leaves behind
    the max, so the two choices give first gradients that differ in a
    large share of those leaves' elements. Each pass lists its ``ties``:
    every feature of a clip whose two largest values differ by less than
    ``slack`` of the pooled tensor's root mean square, as
    ``(gap, call, clip, feature)``; a pass given ``flips`` takes the
    runner-up node at those places. :class:`ReferenceRun` tries the
    ``most`` closest ties of a step both ways and keeps the choice whose
    gradient the program's matches best."""

    def __init__(self, slack: float, most: int):
        self.slack, self.most = slack, most
        self.start(())

    def start(self, flips) -> None:
        self.calls = 0
        self.flips = frozenset(flips)
        self.ties: List[Tuple[float, int, int, int]] = []

    def pool(self, feat: torch.Tensor) -> torch.Tensor:
        """``feat`` (B, N, F) to (B, F)."""
        call = self.calls
        self.calls += 1
        with torch.no_grad():
            top = feat.detach().topk(2, dim=1)
            scale = feat.detach().pow(2).mean().sqrt()
            gap = (top.values[:, 0] - top.values[:, 1]) / scale
            near = (gap < self.slack).nonzero().tolist()
        self.ties += [(float(gap[b, f]), call, b, f) for b, f in near]
        mine = [(b, f) for c, b, f in self.flips if c == call]
        if not mine:
            return feat.amax(1)
        idx = top.indices[:, 0].clone()
        for b, f in mine:
            idx[b, f] = top.indices[b, 1, f]
        return feat.gather(1, idx[:, None, :])[:, 0]

    def choices(self) -> List[Tuple[Tuple[int, int, int], ...]]:
        """Every set of the pass's ``most`` closest ties to flip, the
        empty set first."""
        closest = [t[1:] for t in sorted(self.ties)[:self.most]]
        return [c for r in range(len(closest) + 1)
                for c in itertools.combinations(closest, r)]


def _head_logits(P: Params, cfg: dict, task: str, prefix: str,
                 feat: torch.Tensor, gen: Optional[torch.Generator],
                 node_max: Optional[NodeMax] = None) -> List[torch.Tensor]:
    """One classifier set of ``task``'s head (``cls`` or ``aux_<t>_cls``)
    on its features, the head dropout drawn afresh for each classifier:
    OSCC on the features max-pooled over the nodes (by ``node_max`` where
    given), AR and LTA a verb and a noun classifier on every node, PNR one
    logit a node."""
    head, rate = f"task.{HEADS[task]}.{prefix}", cfg["task_head_dropout"]
    if task == "oscc":
        pooled = feat.amax(1) if node_max is None else node_max.pool(feat)
        return [_linear(P, f"{head}.TLinear_0", _dropout(pooled, rate, gen))]
    if task in ("ar", "lta"):
        return [_linear(P, f"{head}{i}.TLinear_0", _dropout(feat, rate, gen))
                for i in range(2)]
    return [_linear(P, f"{head}.TLinear_0", _dropout(feat, rate, gen))[..., 0]]


def _phase2_loss(task: str, logits: List[torch.Tensor],
                 y: torch.Tensor) -> torch.Tensor:
    """The novel task's published criterion, averaged over every sample
    (OSCC) or every node (AR, LTA, PNR) of the batch."""
    if task == "oscc":
        return cross_entropy(logits[0], y, smoothing=0.1).mean()
    if task in ("ar", "lta"):
        return sum(cross_entropy(l, y[..., i])
                   for i, l in enumerate(logits)).mean()
    return F.binary_cross_entropy_with_logits(logits[0], y.float(),
                                              reduction="none").mean()


def phase2_losses(P: Params, cfg: dict, batches: Dict[str, Batch],
                  gen: Optional[torch.Generator],
                  banks: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                  knn: "KnnJudge", node_max: Optional[NodeMax] = None
                  ) -> Dict[str, torch.Tensor]:
    """The novel task's loss (``main_egopack.py``), the novel task being
    ``cfg["tasks"][0]``: the backbone, in train mode where
    ``temporal_graph_train_mode`` (the pooling's dropout) and with its
    gradient where ``backprop_temporal_graph`` (else under no_grad, as the
    published ``set_grad_enabled``); the novel head's projection and its
    classifiers; with ``late_fusion`` the aux heads' projections of the
    same features (detached) through GraphONE, each met by the novel
    head's classifier set of that aux task, the logits summed over the
    sets (averaged for OSCC); the criterion of :func:`_phase2_loss`."""
    task = cfg["tasks"][0]
    batch = batches[task]
    x = expand_nodes(cfg, task, batch["x"])
    with torch.set_grad_enabled(cfg["backprop_temporal_graph"]):
        h = trn_pooling(P, cfg, x, gen if cfg["temporal_graph_train_mode"]
                        else None)
        adj, pos = task_graph(cfg, task, batch["y"])
        feat = reason(P, cfg, h, adj, pos)
    b, n = feat.shape[:2]
    sets = [_head_logits(P, cfg, task, "cls", project(P, HEADS[task], feat),
                         gen, node_max)]
    if cfg["late_fusion"]:
        flat = feat.reshape(b * n, -1).detach()
        with torch.no_grad():
            secondary = {t: project(P, HEADS[t], flat)
                         for t in cfg["aux_tasks"]}
        neighbours = knn.neighbours(secondary, banks)
        inter = graphone(P, cfg, secondary, banks, neighbours)
        sets += [_head_logits(P, cfg, task, f"aux_{t}_cls",
                              inter[t].reshape(b, n, -1), gen, node_max)
                 for t in cfg["aux_tasks"]]
    stacks = [torch.stack(parts) for parts in zip(*sets)]
    logits = [s.mean(0) if task == "oscc" else s.sum(0) for s in stacks]
    return {task: _phase2_loss(task, logits, batch["y"])}


def _valid_lists(idx: torch.Tensor, shape: torch.Size,
                 mask: torch.Tensor) -> bool:
    """Each row of ``idx`` names ``k`` distinct valid rows of the bank."""
    if idx.shape != shape:  # not the rows asked about
        return False
    if bool(((idx < 0) | (idx >= mask.shape[0])).any()):
        return False
    if not bool(mask[idx].all()):
        return False
    ordered = idx.sort(dim=-1).values
    return not bool((ordered[:, 1:] == ordered[:, :-1]).any())


class KnnJudge:
    """The k-NN stage of the reference, and its check of the program's.

    Without a program reading (``seen`` empty) it returns its own k
    nearest. With the program's ``(indices, distances)`` of a call it
    judges them against its own distance matrix and continues with the
    program's neighbours, so that a tie the two sides break apart within
    rounding does not spread into the numbers compared after it:

    - ``slack``: the worst, over rows and ranks j, of how far the program's
      j-th neighbour lies from the true j-th, either way, by this
      reference's distances (0 when the program's list is exact,
      rounding-sized at a near-tie, and large for a wrong or misplaced
      neighbour); a list whose indices repeat, leave the bank or name a
      masked row reads ``inf``, as does one of the wrong shape;
    - ``dist_gap``: the worst gap between a distance the program reported
      and this reference's distance of the same row.

    ``produced`` keeps its own lists of each call, stacked over the tasks
    as the program returns them."""

    def __init__(self, k: int, dtype: torch.dtype = torch.float64,
                 seen: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None):
        self.k, self.dtype = k, dtype
        self.seen = list(seen or [])
        self.calls = 0
        self.produced: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.slack = 0.0
        self.dist_gap = 0.0

    def neighbours(self, secondary: Dict[str, torch.Tensor],
                   banks) -> Dict[str, torch.Tensor]:
        call = self.calls
        self.calls += 1
        out, made = {}, []
        for ti, (t, f) in enumerate(secondary.items()):
            bank, mask = banks[t]
            idx, dist, d = cosine_topk(f, bank, mask, self.k, self.dtype)
            made.append((idx, dist))
            if call < len(self.seen):
                p_idx = self.seen[call][0][ti].to(d.device).long()
                p_dist = self.seen[call][1][ti].to(d.device, d.dtype)
                if not _valid_lists(p_idx, idx.shape, mask):
                    self.slack = self.dist_gap = math.inf
                    out[t] = idx
                    continue
                mine = torch.gather(d, 1, p_idx)
                self.slack = max(self.slack,
                                 float((mine - dist).abs().max()))
                self.dist_gap = max(self.dist_gap,
                                    float((p_dist - mine).abs().max()))
                idx = p_idx
            out[t] = idx
        self.produced.append((torch.stack([i for i, _ in made]).cpu(),
                              torch.stack([d for _, d in made]).cpu()))
        return out

    def state(self) -> tuple:
        return self.calls, len(self.produced), self.slack, self.dist_gap

    def restore(self, state: tuple) -> None:
        """Back to :meth:`state`'s reading, so that a pass taken again
        judges and records its calls once."""
        self.calls, n, self.slack, self.dist_gap = state
        del self.produced[n:]


ELEMENT_TOL = 1e-2  # of the leaf's root mean square


def elements_off(prog: Params, want: Params, names: Sequence[str]) -> float:
    """The share of all the elements of the leaves ``names`` in which
    ``prog`` differs from ``want`` by more than ``ELEMENT_TOL`` of the root
    mean square of ``want``'s leaf (``inf`` where a leaf is missing or of
    another shape)."""
    if not prog:
        return math.inf
    off = total = 0
    for n in names:
        w = want[n]
        p = prog[n].to(w.device)
        if p.shape != w.shape:
            return math.inf
        tol = ELEMENT_TOL * w.double().pow(2).mean().sqrt()
        diff = (p.double() - w.double()).abs()
        off += int((~(diff <= tol)).sum())
        total += w.numel()
    return off / total


# OSCC's max over the nodes (``NodeMax``): a tie is closer than this share
# of the pooled tensor's root mean square, and a step tries at most this
# many of its closest ties both ways
NODE_TIE_SLACK = 1e-4
NODE_TIES_TRIED = 4


def pools_over_nodes(cfg: dict) -> bool:
    """Whether the step's loss takes a max over each clip's nodes: phase 1
    with OSCC among the tasks, phase 2 with OSCC the novel task."""
    if cfg["phase"] == 1:
        return "oscc" in cfg["tasks"]
    return cfg["tasks"][0] == "oscc"


# ---------------- a training step ----------------

class ReferenceRun:
    """Steps of the reference from the initial parameters: records each
    step's total loss, the first step's gradient as Adam receives it
    (coupled weight decay added: its tensors and each leaf's norm) and the
    plain gradient's norm, per trainable leaf, and the change of each
    trainable leaf over the steps taken.

    ``follow`` holds the program's gradient as Adam received it, a dict a
    step: where a step's loss pools over nodes with ties
    (:class:`NodeMax`), each choice of the closest is taken and the one
    whose gradient the program's differs from in the fewest elements
    (:func:`elements_off`) is kept; ``followed`` lists, a step, the ties
    flipped as ``(gap, call, clip, feature)``. With ``keep_grads`` each
    step's gradient as Adam received it is kept on the host
    (``step_grads``), for a reference that stands in the program's
    place."""

    def __init__(self, cfg: dict, params: Params, trainable: Sequence[str],
                 banks=None, knn: Optional[KnnJudge] = None,
                 follow: Sequence[Params] = (), keep_grads: bool = False):
        self.cfg = cfg
        self.P = {n: p.detach().clone() for n, p in params.items()}
        self.names = list(trainable)
        self.start = {n: self.P[n].clone() for n in self.names}
        for n in self.names:
            self.P[n].requires_grad_(True)
        self.opt = torch.optim.Adam([self.P[n] for n in self.names],
                                    lr=cfg["lr"], betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=cfg["weight_decay"],
                                    foreach=False, fused=False)
        self.banks = banks
        self.knn = knn
        self.node_max = (NodeMax(NODE_TIE_SLACK, NODE_TIES_TRIED)
                         if pools_over_nodes(cfg) else None)
        self.follow = list(follow)
        self.keep_grads = keep_grads
        self.losses: List[float] = []
        self.first_grad: Dict[str, float] = {}
        self.first_plain_grad: Dict[str, float] = {}
        self.first_grad_tensors: Params = {}
        self.step_grads: List[Params] = []
        self.followed: List[List[Tuple[float, int, int, int]]] = []

    def _pass(self, batches: Dict[str, Batch],
              gen: Optional[torch.Generator], flips=()):
        """The step's loss and its gradient, each max over nodes flipped at
        ``flips``."""
        if self.node_max is not None:
            self.node_max.start(flips)
        if self.cfg["phase"] == 1:
            parts = phase1_losses(self.P, self.cfg, batches, gen,
                                  self.node_max)
        else:
            parts = phase2_losses(self.P, self.cfg, batches, gen, self.banks,
                                  self.knn, self.node_max)
        total = sum(parts.values())
        grads = torch.autograd.grad(total, [self.P[n] for n in self.names],
                                    allow_unused=True, materialize_grads=True)
        return total, grads

    def _as_adam_gets(self, grads) -> Params:
        wd = self.cfg["weight_decay"]
        return {n: g.detach() + wd * self.P[n].detach()
                for n, g in zip(self.names, grads)}

    def _follow_ties(self, batches: Dict[str, Batch],
                     gen: Optional[torch.Generator], states: tuple,
                     want: Params, base: tuple):
        """Of the passes that flip each choice of the base pass's closest
        ties (:meth:`NodeMax.choices`), the one whose gradient ``want``
        differs from in the fewest elements, the base pass where none
        does better: ``(total, grads, u, ties flipped)``."""
        gaps = {t[1:]: t[0] for t in self.node_max.ties}
        best = base + ((),)
        off = elements_off(want, base[2], self.names)
        for flips in self.node_max.choices()[1:]:
            if off == 0.0:
                break
            if gen is not None:
                gen.set_state(states[0])
            if self.knn is not None:
                self.knn.restore(states[1])
            total, grads = self._pass(batches, gen, flips)
            u = self._as_adam_gets(grads)
            this = elements_off(want, u, self.names)
            if this < off:
                off, best = this, (total, grads, u, flips)
        *kept, flips = best
        return (*kept, [(gaps[f], *f) for f in flips])

    def step(self, batches: Dict[str, Batch],
             gen: Optional[torch.Generator]) -> None:
        at = len(self.losses)
        states = (gen.get_state() if gen is not None else None,
                  self.knn.state() if self.knn is not None else None)
        total, grads = self._pass(batches, gen)
        u, taken = self._as_adam_gets(grads), []
        if at < len(self.follow) and self.node_max is not None \
                and self.node_max.ties:
            total, grads, u, taken = self._follow_ties(
                batches, gen, states, self.follow[at], (total, grads, u))
        self.followed.append(taken)
        if not self.losses:
            for n, g in zip(self.names, grads):
                self.first_plain_grad[n] = float(g.double().norm())
                self.first_grad[n] = float(u[n].double().norm())
                self.first_grad_tensors[n] = u[n]
        if self.keep_grads:
            self.step_grads.append({n: v.cpu() for n, v in u.items()})
        for n, g in zip(self.names, grads):
            self.P[n].grad = g
        self.opt.step()
        self.losses.append(float(total.detach()))

    def change(self) -> Dict[str, float]:
        return {n: float((self.P[n].detach() - self.start[n]).double().norm())
                for n in self.names}
