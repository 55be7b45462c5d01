"""The multi-task system: backbone + task heads + the train and eval steps
(counterpart of ``egopack_tpu/train/system.py``).

The multi-task loss is a sum over the active tasks, so one backward over it
reproduces the reference's ``torch.stack(losses).sum().backward()``. The
tasks' node sets are pooled in one product and, in the ``concat`` layout,
reasoned over as one block-diagonal graph.

Phase-2 (EgoPack) steps keep the reference's gradient topology
(reference main_egopack.py:45-61): the aux-task features are detached before
the GraphONE interaction, the k-NN edges are not differentiable,
``backprop_temporal_graph=False`` stops gradients at the backbone output, and
the GraphONE stages learn through the interacted features.

Parameters live in ``MultiTaskSystem.model``, an ``nn.ModuleDict`` whose
names follow the flax tree (``temporal_graph``, ``task.recognition``, ...,
``graphone``, ``graphone_banks``; see ``interop.py``). The steps update them
in place.

On a mesh (``parallel/mesh.py:place_params``) each rank holds its block of
every global batch and its shards of the split parameters. The steps keep
the global batch's meaning (``egopack_tpu/train/system.py:467-481``): each
task's masked mean divides this rank's masked sum by the count over the
whole data axis, so the gradients summed over the axis are those of the
global loss, whatever share of valid samples each rank holds; the graph
LayerNorms take the global batch's statistics; dropout masks are drawn at
the global batch's shape (``ShardedGenerator``); the fused layout is chosen
by the global node count; and the norms count each replicated leaf once and
sum the squares of split leaves over the model axis.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .. import interop
from ..data.graphs import GraphSpec
from ..device import DeviceLike, resolve_device
from ..models.backbone import TemporalGraph
from ..models.graphone import GraphONE, PrototypeBank
from ..models.layers import GraphLayerNorm, ShardedGenerator
from ..ops.losses import bce_with_logits, cross_entropy, masked_mean
from ..parallel.collectives import all_reduce_
from ..parallel.mesh import Mesh, gather_params
from ..tracing import span
from .optim import Adam, AdamState

TASK_ORDER = ("ar", "lta", "oscc", "pnr")

# checkpoint keys mirror the reference state dict
# (reference main_temporal.py:410-416)
CKPT_KEYS = {"ar": "task/recognition", "oscc": "task/oscc",
             "lta": "task/lta", "pnr": "task/pnr"}

Batch = Dict[str, torch.Tensor]
Logs = Dict[str, torch.Tensor]
Banks = Dict[str, PrototypeBank]


@dataclass
class TaskSetup:
    name: str
    head: nn.Module
    spec: GraphSpec
    weight: float = 1.0
    # LTA forecast-node fill ("avg" / "zero"): the loader ships only the
    # real input clips and expand_x builds the forecast nodes on the device
    append_node: Optional[str] = None


def lta_full_adjacency(base_adj: torch.Tensor, y: torch.Tensor,
                       radius: float) -> torch.Tensor:
    """Per-sample LTA adjacency: radius chain + forecast edges, with the
    strict ``y > 0`` forecast count of the reference (see data/graphs.py).
    base_adj (N, N) bool; y (B, N, 2); returns (B, N, N) bool."""
    n = y.shape[1]
    verb = y[..., 0]
    ni = (verb == -1).sum(1)[:, None, None]
    nf = (verb > 0).sum(1)[:, None, None]
    idx = torch.arange(n, device=y.device)
    t_idx = idx[None, :, None]  # targets
    s_idx = idx[None, None, :]  # sources
    src_lo = torch.clamp_min(torch.ceil(ni - radius).long(), 0)
    extra = ((s_idx >= src_lo) & (s_idx < ni)
             & (t_idx >= ni) & (t_idx < ni + nf))
    return base_adj[None] | extra


def _global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every tensor (optax.global_norm semantics)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def _sharded_norm(named: Dict[str, torch.Tensor], shards: Dict[str, int],
                  mesh: Mesh) -> torch.Tensor:
    """``_global_norm`` of tensors of which those named in ``shards`` hold
    this rank's slice of a tensor split over the model axis: their squares
    are summed over the axis, the replicated ones counted once."""
    split = [t for n, t in named.items() if n in shards]
    if not split:
        return _global_norm(list(named.values()))
    sq = all_reduce_(sum(torch.sum(torch.square(t.float())) for t in split),
                     mesh.model_axis)
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for n, t in named.items() if n not in shards) + sq)


@functools.lru_cache(maxsize=8)
def _layer_groups(names: Tuple[str, ...]) -> Dict[str, Tuple[str, ...]]:
    """The subtrees of ``_subtree_norms`` over torch parameter names: the
    flax tree's first two levels, rebuilt through ``interop``'s name map. A
    top-level key whose children are all modules splits into one group per
    child (``temporal_graph/pooling``, ``temporal_graph/gn0``, ...); one with
    a leaf among its children (``graphone``) is one group."""
    paths = {n: interop.flax_path(n, 0) for n in names}
    tops: Dict[str, List[str]] = {}
    for n in names:
        tops.setdefault(paths[n][0], []).append(n)
    groups: Dict[str, List[str]] = {}
    for top, members in tops.items():
        if all(len(paths[n]) >= 3 for n in members):
            for n in members:
                groups.setdefault(f"{top}/{paths[n][1]}", []).append(n)
        else:
            groups[top] = members
    return {k: tuple(v) for k, v in groups.items()}


def _subtree_norms(params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor],
                   norm: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
                   ) -> Logs:
    """Per-layer L2 norms of the gradients and the parameters, one scalar
    per subtree of ``_layer_groups``, with JAX's keys
    (``grad_norm/temporal_graph/sage0``, ``param_norm/graphone``;
    ``egopack_tpu/train/system.py:82-97``), each by ``norm`` over the
    subtree's named tensors. JAX differentiates every leaf, so a subtree
    outside the trainable set has a gradient norm of 0."""
    out: Logs = {}
    for key, members in _layer_groups(tuple(params)).items():
        g = {n: grads[n] for n in members if n in grads}
        out[f"grad_norm/{key}"] = (norm(g) if g else
                                   params[members[0]].new_zeros(()))
        out[f"param_norm/{key}"] = norm(
            {n: params[n].detach() for n in members})
    return out


def histogram(values: torch.Tensor, bins: int = 64
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.histogram(values.ravel(), bins)`` in float32: ``bins`` equal
    bins over [min, max] ([v - 0.5, v + 0.5] when every value is v), edges
    by JAX's ``linspace`` (``lo * (1 - s) + hi * s`` for s = i / bins), each
    value in the bin whose left edge it reaches, the last bin closed on the
    right. Returns (counts (bins,) float32, edges (bins + 1,) float32).

    ``torch.histc`` bins by arithmetic, widens a constant input by 1 on
    each side and returns no edges; ``torch.histogram`` has no CUDA kernel.
    So the bins come from ``torch.bucketize`` on the edges, as numpy's and
    JAX's ``searchsorted`` give them."""
    x = values.detach().float().reshape(-1)
    lo, hi = x.min(), x.max()
    flat = lo == hi
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    s = torch.arange(bins, dtype=torch.float32, device=x.device) / bins
    edges = torch.cat([lo * (1 - s) + hi * s, hi[None]])
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.bincount(idx, minlength=bins + 1)[1:bins + 1]
    return counts.float(), edges


def _tree_histograms(tensors: Dict[str, torch.Tensor], prefix: str,
                     bins: int) -> Dict[str, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """``histogram`` of every tensor, keyed ``<prefix>/<flax path>``
    (``grad_hist/temporal_graph/pooling/fc0/kernel``;
    ``egopack_tpu/train/system.py:100-115``). A kernel's histogram does not
    depend on its layout, so the torch ``weight`` needs no transpose."""
    return {f"{prefix}/" + "/".join(interop.flax_path(n, t.ndim)):
            histogram(t, bins) for n, t in tensors.items()}


def _phase1_task_loss(name: str, logits, y: torch.Tensor) -> torch.Tensor:
    """Per-element phase-1 criteria (reference main_temporal.py:281-298):
    AR/LTA: plain CE(ignore -1) summed over verb+noun heads; OSCC: plain CE;
    PNR: BCE-with-logits on the float one-hot."""
    if name in ("ar", "lta"):
        return torch.stack([cross_entropy(l, y[..., i])
                            for i, l in enumerate(logits)]).sum(0)  # (B, N)
    if name == "oscc":
        return cross_entropy(logits, y)  # (B,)
    if name == "pnr":
        return bce_with_logits(logits, y.float())  # (B, N)
    raise ValueError(name)


def _phase2_task_loss(head: nn.Module, logits, y: torch.Tensor
                      ) -> torch.Tensor:
    """Phase-2 criteria are each head's ``compute_loss`` (reference
    main_egopack.py:61; OSCC gains the label smoothing 0.1 that phase 1
    lacks)."""
    return head.compute_loss(logits, y)


def _effective_banks(model: nn.ModuleDict, banks: Banks) -> Banks:
    """``freeze=False``: when the bank values are parameters
    (``graphone_banks``), the banks are rebuilt from them so that gradients
    reach them (the reference's ``nn.Embedding.from_pretrained(freeze=False)``);
    the masks stay as given."""
    if "graphone_banks" not in model:
        return banks
    values = model["graphone_banks"]
    return {t: PrototypeBank(values[t], banks[t].mask) for t in banks}


@dataclass
class _ConcatConsts:
    """Device constants of the concat layout for one (task, batch, nodes)
    signature: per-row task/sample/node ids, the static block-diagonal
    adjacency, the same-(task, sample) pair mask, the task one-hot and the
    concatenated node positions."""
    tid: torch.Tensor
    sid: torch.Tensor
    nid: torch.Tensor
    static_adj: torch.Tensor
    same: torch.Tensor
    onehot: torch.Tensor
    pos: torch.Tensor


class MultiTaskSystem:
    """Owns the backbone + heads and builds the phase-1 train steps."""

    # Auto layout: concat up to this many concatenated nodes, else slice.
    # The crossover was measured on a TPU; an H100 measurement is still to
    # come, so the rule stays as it is.
    CONCAT_AUTO_MAX_NODES = 1024

    def __init__(self, backbone: TemporalGraph, tasks: Dict[str, TaskSetup],
                 compute_dtype: torch.dtype = torch.float32,
                 fused_layout: Optional[str] = None, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.backbone = backbone
        self.tasks = tasks
        self.compute_dtype = compute_dtype
        # "slice": pool fused, then reason per task (reason_multi).
        # "concat": keep the concatenated node set through the whole reason
        # stack (reason_concat). "auto": by concatenated node count. None:
        # the EGOPACK_FUSED_LAYOUT environment variable, else "auto"
        # (egopack_tpu/train/system.py:164-166).
        if fused_layout is None:
            fused_layout = os.environ.get("EGOPACK_FUSED_LAYOUT", "auto")
        self.fused_layout = fused_layout
        self.model = nn.ModuleDict({
            "temporal_graph": backbone,
            "task": nn.ModuleDict({CKPT_KEYS[n].split("/")[1]: s.head
                                   for n, s in sorted(tasks.items())}),
        })
        self._task_consts = {
            n: (torch.as_tensor(s.spec.adjacency, device=self.device),
                torch.as_tensor(s.spec.pos, device=self.device))
            for n, s in tasks.items()}
        self._concat_cache: Dict[tuple, _ConcatConsts] = {}
        # the rank grid, and {name: split dim} of the parameters split
        # over its model axis (``parallel/mesh.py:place_params``)
        self.mesh = Mesh(device=self.device)
        self.shards: Dict[str, int] = {}

    def _resolve_layout(self, total_nodes: int) -> str:
        layout = self.fused_layout
        if layout == "auto":
            return ("concat" if total_nodes <= self.CONCAT_AUTO_MAX_NODES
                    else "slice")
        if layout not in ("concat", "slice"):
            raise ValueError(
                f"fused_layout must be 'auto'|'concat'|'slice', got {layout!r}")
        return layout

    # ---------------- parameters ----------------
    def params(self) -> Dict[str, nn.Parameter]:
        return dict(self.model.named_parameters())

    def use_mesh(self, mesh: Mesh) -> None:
        """Wire the modules to ``mesh``: the graph LayerNorms reduce over
        its data axis, the pooling MLP over its model axis when its layers
        are split, GraphONE's banks are split over the model axis."""
        self.mesh = mesh
        for m in self.model.modules():
            if isinstance(m, GraphLayerNorm):
                m.data_axis = mesh.data_axis
        if "temporal_graph.pooling.fc0.weight" in self.shards:
            self.backbone.pooling.model_axis = mesh.model_axis
        if "graphone" in self.model:
            self.model["graphone"].model_axis = mesh.model_axis

    def full_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter at its full shape: split ones gathered over the
        model axis (a collective on a mesh; every rank calls it)."""
        return gather_params(self.params(), self.shards, self.mesh)

    def _norm(self, named: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _sharded_norm(named, self.shards, self.mesh)

    def sample_generator(self, generator: Optional[torch.Generator]):
        """``generator`` for this rank's block of a batch split over the
        data axis: the global batch's masks (``ShardedGenerator``)."""
        if generator is None or self.mesh.data == 1:
            return generator
        return ShardedGenerator(generator, self.mesh.data_index,
                                self.mesh.data)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator
                    ) -> Dict[str, nn.Parameter]:
        """Torch-default init of every parameter, drawn from ``generator``
        (which lives on the system's device)."""
        for module in self.model.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self.params()

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy a full torch state (see ``interop.from_flax``) in."""
        self.model.load_state_dict(state, strict=True)

    def attach_graphone(self, graphone: GraphONE,
                        trainable_banks: Optional[Banks] = None) -> None:
        """Register the GraphONE stages as ``graphone`` and, for
        ``freeze=False``, copies of the bank values as trainable
        ``graphone_banks.<task>`` parameters."""
        self.model["graphone"] = graphone
        if trainable_banks is not None:
            self.model["graphone_banks"] = nn.ParameterDict({
                t: nn.Parameter(b.values.detach().clone())
                for t, b in trainable_banks.items()})

    # ---------------- forward pieces ----------------
    def expand_x(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Build the dense node layout on the device from compact batches:
        PNR ``(B, N, D)`` repeats each frame S times per node; LTA ships its
        input clips and the forecast nodes are their mean (or zeros).
        Full batches pass through."""
        setup = self.tasks[name]
        if x.ndim == 3:
            x = x[:, :, None, :].expand(-1, -1, self.backbone.num_segments, -1)
        n = setup.spec.num_nodes
        if x.shape[1] != n:
            fill_shape = (x.shape[0], n - x.shape[1]) + tuple(x.shape[2:])
            mode = setup.append_node or "avg"
            if mode == "avg":
                fill = x.mean(1, keepdim=True).expand(fill_shape)
            elif mode == "zero":
                fill = x.new_zeros(fill_shape)
            else:
                raise ValueError(
                    f"compact batch for {name} with append_node={mode}; "
                    "the loader must ship the full layout for this mode")
            x = torch.cat([x, fill], 1)
        return x

    def _fuse_sig(self, x: torch.Tensor) -> Tuple[int, int]:
        """(segments, feature_dim) AFTER expansion: what fusion compares."""
        s = self.backbone.num_segments if x.ndim == 3 else x.shape[2]
        return (s, x.shape[-1])

    def _can_fuse(self, batches: Dict[str, Batch], names) -> bool:
        shapes = {self._fuse_sig(batches[n]["x"]) for n in names}
        return len(shapes) == 1 and len(names) > 1

    def _task_adj(self, name: str, y: torch.Tensor) -> torch.Tensor:
        spec = self.tasks[name].spec
        base_adj = self._task_consts[name][0]
        if spec.lta_extra:
            return lta_full_adjacency(base_adj, y, spec.radius)
        return base_adj

    def backbone_features(self, batch: Batch, name: str, train: bool,
                          generator: Optional[torch.Generator]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The shared backbone on one task's batch; returns
        (features (B, N, H) float32, node_mask (B, N))."""
        x = self.expand_x(name, batch["x"]).to(self.compute_dtype)
        node_mask = batch["valid"][:, None].expand(x.shape[:2])
        feat = self.backbone(x, self._task_adj(name, batch["y"]),
                             self._task_consts[name][1], node_mask,
                             train=train, generator=generator)
        return feat.float(), node_mask

    def _concat_static(self, metas) -> _ConcatConsts:
        """Constants of the concat layout, built once per signature: LTA's
        forecast edges depend on the labels and are added per step."""
        key = tuple(metas)
        if key in self._concat_cache:
            return self._concat_cache[key]
        tid, sid, nid, pos = [], [], [], []
        for ti, (name, b, n) in enumerate(metas):
            tid.append(np.full(b * n, ti, np.int64))
            sid.append(np.repeat(np.arange(b, dtype=np.int64), n))
            nid.append(np.tile(np.arange(n, dtype=np.int64), b))
            pos.append(np.tile(np.asarray(self.tasks[name].spec.pos), b))
        tid, sid, nid = map(np.concatenate, (tid, sid, nid))
        same = (tid[:, None] == tid[None]) & (sid[:, None] == sid[None])
        static_adj = np.zeros((tid.size, tid.size), bool)
        off = 0
        for name, b, n in metas:
            a = np.asarray(self.tasks[name].spec.adjacency)
            sel = slice(off, off + b * n)
            static_adj[sel, sel] = (same[sel, sel]
                                    & a[nid[sel][:, None], nid[sel][None, :]])
            off += b * n
        onehot = tid[None, :] == np.arange(len(metas))[:, None]
        dev = self.device
        consts = _ConcatConsts(
            *(torch.as_tensor(a, device=dev) for a in (tid, sid, nid,
                                                       static_adj, same)),
            onehot=torch.as_tensor(onehot, dtype=torch.float32, device=dev),
            pos=torch.as_tensor(np.concatenate(pos), dtype=torch.float32,
                                device=dev))
        self._concat_cache[key] = consts
        return consts

    def _concat_adjacency(self, metas, batches: Dict[str, Batch],
                          c: _ConcatConsts) -> torch.Tensor:
        """Block-diagonal in-neighbour mask over the concatenated node set:
        the static base graphs plus each LTA-style task's label-dependent
        forecast edges (lta_full_adjacency, as conditions on per-row ids)."""
        adj = c.static_adj
        for ti, (name, b, n) in enumerate(metas):
            spec = self.tasks[name].spec
            if not spec.lta_extra:
                continue
            verb = batches[name]["y"][..., 0]            # (b, n)
            ni = (verb == -1).sum(1)                     # (b,)
            nf = (verb > 0).sum(1)
            is_t = c.tid == ti
            # rows of other tasks may carry sample ids beyond this batch;
            # is_t masks them, the clamp keeps the gather in range
            row = torch.clamp_max(c.sid, b - 1)
            ni_r, nf_r = ni[row], nf[row]
            src_lo = torch.clamp_min(torch.ceil(ni_r - spec.radius).long(), 0)
            src_ok = is_t & (c.nid >= src_lo) & (c.nid < ni_r)
            fc = is_t & (c.nid >= ni_r) & (c.nid < ni_r + nf_r)
            adj = adj | (fc[:, None] & src_ok[None, :] & c.same)
        return adj

    def fused_backbone_features(self, batches: Dict[str, Batch],
                                names: Sequence[str], train: bool,
                                generator: Optional[torch.Generator]
                                ) -> Dict[str, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
        """Pool the node sets of ALL task branches in one product, then
        reason per layout. Needs every task to share (S, D)."""
        xs, metas = [], []
        for name in names:
            x = self.expand_x(name, batches[name]["x"]).to(self.compute_dtype)
            b, n = x.shape[0], x.shape[1]
            xs.append(x.reshape(1, b * n, x.shape[2], x.shape[3]))
            metas.append((name, b, n))
        pool_gen = generator
        if isinstance(generator, ShardedGenerator):
            # this rank's rows of the global concatenation of the tasks'
            # node sets
            rows, total = [], 0
            for _, b, n in metas:
                rows.append(total + generator.index * b * n
                            + torch.arange(b * n, device=self.device))
                total += generator.count * b * n
            pool_gen = generator.with_rows(torch.cat(rows), total)
        h_all = self.backbone.pool(torch.cat(xs, 1), train, pool_gen)[0]
        masks = [batches[name]["valid"][:, None].expand(b, n)
                 for name, b, n in metas]
        layout = self._resolve_layout(
            sum(b * n for _, b, n in metas) * self.mesh.data)
        if layout == "concat":
            c = self._concat_static(metas)
            adj_cc = self._concat_adjacency(metas, batches, c)
            mask_cc = torch.cat([m.reshape(-1) for m in masks])
            feats_cc = self.backbone.reason_concat(h_all[None], adj_cc, c.pos,
                                                   mask_cc, c.onehot)
            out, off = {}, 0
            for (name, b, n), mask in zip(metas, masks):
                feat = feats_cc[0, off:off + b * n].reshape(b, n, -1)
                out[name] = (feat.float(), mask)
                off += b * n
            return out
        hs, adjs, poss, off = [], [], [], 0
        for name, b, n in metas:
            hs.append(h_all[off:off + b * n].reshape(b, n, -1))
            off += b * n
            adjs.append(self._task_adj(name, batches[name]["y"]))
            poss.append(self._task_consts[name][1])
        feats = self.backbone.reason_multi(hs, adjs, poss, masks)
        return {name: (feat.float(), mask)
                for (name, _, _), feat, mask in zip(metas, feats, masks)}

    # ---------------- phase 1: multi-task step ----------------
    def _make_phase1_loss_fn(self, active: Tuple[str, ...]
                             ) -> Callable[..., Tuple[torch.Tensor, Logs]]:
        def loss_fn(batches: Dict[str, Batch],
                    generator: Optional[torch.Generator]):
            total, logs = 0.0, {}
            generator = self.sample_generator(generator)
            fused = self._can_fuse(batches, active)
            if fused:
                feats = self.fused_backbone_features(batches, active, True,
                                                     generator)
            for name in active:
                batch = batches[name]
                if fused:
                    feat, node_mask = feats[name]
                else:
                    feat, node_mask = self.backbone_features(
                        batch, name, True, generator)
                head = self.tasks[name].head
                tfeat = head.forward_features(feat, True, generator)
                logits = head.forward_logits(
                    tfeat, node_mask if name == "oscc" else None, True,
                    generator)
                per_elem = _phase1_task_loss(name, logits, batch["y"])
                mask = batch["valid"] if per_elem.ndim == 1 else node_mask
                loss = masked_mean(per_elem, mask, self.mesh.data_axis)
                logs[f"{name}_loss"] = loss
                total = total + self.tasks[name].weight * loss
            return total, logs

        return loss_fn

    def _make_inner_step(self, optimizer: Adam,
                         loss_fn: Callable[..., Tuple[torch.Tensor, Logs]],
                         per_layer_norms: bool = False):
        """One optimizer step on ``loss_fn(*args)``:
        ``inner(opt_state, args, log_norms) -> logs``. ``per_layer_norms``
        adds ``_subtree_norms`` to every step's logs. Spans
        (``egopack_torch.tracing``) mark the step and, inside it, its
        forward, backward, norms and optimizer phases. On a data axis the
        gradients and the logged losses are summed over it (each rank's
        loss is its share of the global one, see
        ``ops.losses.masked_mean``)."""

        def inner_step(opt_state: AdamState, args: tuple,
                       log_norms: bool) -> Logs:
            params = self.params()
            names = optimizer.trainable_names(params)
            with span("egopack.forward"):
                total, logs = loss_fn(*args)
            # gradients of the trainable leaves only (torch grad=None for
            # the rest); a trainable leaf outside the graph gets zeros, as
            # in JAX
            with span("egopack.backward"):
                grads = torch.autograd.grad(total, [params[n] for n in names],
                                            materialize_grads=True)
            logs = {k: v.detach() for k, v in logs.items()}
            with torch.no_grad():
                grads = self._sum_over_data(grads)
                keys = sorted(logs)
                logs = dict(zip(keys, self._sum_over_data(
                    [logs[k] for k in keys])))
                named = dict(zip(names, grads))
                if log_norms or per_layer_norms:
                    with span("egopack.norms"):
                        if log_norms:
                            logs["grad_norm"] = self._norm(named)
                            logs["param_norm"] = self._norm(params)
                        if per_layer_norms:
                            logs.update(_subtree_norms(params, named,
                                                       self._norm))
            with span("egopack.optimizer"):
                optimizer.apply(named, opt_state, params)
            return logs

        def step(opt_state: AdamState, args: tuple, log_norms: bool) -> Logs:
            with span("egopack.step"):
                return inner_step(opt_state, args, log_norms)

        return step

    def _sum_over_data(self, tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """``tensors`` summed over the data axis in one collective (float32
        tensors, flattened into one buffer); as they are on one data
        row."""
        tensors = list(tensors)
        if self.mesh.data == 1 or not tensors:
            return tensors
        flat = all_reduce_(torch.cat([t.reshape(-1).float() for t in tensors]),
                           self.mesh.data_axis)
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].view_as(t).to(t.dtype))
            off += t.numel()
        return out

    @staticmethod
    def _multi(inner, opt_state: AdamState, arg_list: Sequence[tuple],
               log_norms) -> Logs:
        """Sequential steps over ``arg_list``; logs stacked on a leading K
        axis. ``log_norms="last"`` computes the norms on the last step only
        (unstacked scalars)."""
        last_only = log_norms == "last"
        all_logs: List[Logs] = []
        for k, args in enumerate(arg_list):
            norms = (k == len(arg_list) - 1) if last_only else log_norms
            all_logs.append(inner(opt_state, args, norms))
        logs = {key: torch.stack([l[key] for l in all_logs])
                for key in all_logs[0]}
        if last_only:
            logs.update({k: v for k, v in all_logs[-1].items()
                         if k not in all_logs[0]})
        return logs

    def make_train_step(self, optimizer: Adam, active: Tuple[str, ...],
                        log_norms: bool = True,
                        per_layer_norms: bool = False):
        """One step over the active tasks:
        ``step(opt_state, batches, generator, lr) -> logs``. Parameters and
        moments update in place; logs are device scalars (no host sync).
        ``log_norms=False`` drops the global grad and param norms;
        ``per_layer_norms`` adds one of each per subtree
        (``_subtree_norms``)."""
        inner = self._make_inner_step(optimizer,
                                      self._make_phase1_loss_fn(active),
                                      per_layer_norms)

        def step(opt_state: AdamState, batches: Dict[str, Batch],
                 generator: Optional[torch.Generator], lr: float) -> Logs:
            opt_state.hyperparams["learning_rate"] = lr
            return inner(opt_state, (batches, generator), log_norms)

        return step

    def make_train_step_multi(self, optimizer: Adam, active: Tuple[str, ...],
                              steps_per_call: int, log_norms=True,
                              per_layer_norms: bool = False):
        """``steps_per_call`` sequential steps over as many batch groups:
        ``multi_step(opt_state, batch_list, generator, lr) -> logs`` with a
        leading K axis on each log. ``log_norms="last"`` computes the global
        norms on the last step only (unstacked scalars); per-layer norms
        are on every step."""
        inner = self._make_inner_step(optimizer,
                                      self._make_phase1_loss_fn(active),
                                      per_layer_norms)

        def multi_step(opt_state: AdamState,
                       batch_list: Sequence[Dict[str, Batch]],
                       generator: Optional[torch.Generator],
                       lr: float) -> Logs:
            opt_state.hyperparams["learning_rate"] = lr
            return self._multi(inner, opt_state,
                               [(batch_list[k], generator)
                                for k in range(steps_per_call)], log_norms)

        return multi_step

    def make_histogram_fn(self, active: Tuple[str, ...],
                          graphone: Optional[GraphONE] = None,
                          bins: int = 64, **phase2_kw):
        """Gradient and weight histograms of every parameter from one batch
        group, taken outside the train step at the driver's epoch cadence
        (``egopack_tpu/train/system.py:527-556``): phase 1
        ``hist_fn(batches, generator)`` when ``graphone`` is None, phase 2
        ``hist_fn(banks, batches, generator)`` (``phase2_kw`` go to
        ``make_egopack_loss_fn``). Returns ``{"grad_hist/<path>": (counts,
        edges), "param_hist/<path>": ...}`` for every leaf; as in JAX, a
        leaf outside the loss graph has a gradient of zeros."""
        loss_fn = (self._make_phase1_loss_fn(active) if graphone is None
                   else self.make_egopack_loss_fn(active, graphone,
                                                  **phase2_kw))

        def hist_fn(*args):
            params = self.params()
            total, _ = loss_fn(*args)
            grads = torch.autograd.grad(total, list(params.values()),
                                        materialize_grads=True)
            with torch.no_grad():
                # whole tensors: the global gradient, split leaves gathered
                grads = gather_params(
                    dict(zip(params, self._sum_over_data(grads))),
                    self.shards, self.mesh)
                full = gather_params(params, self.shards, self.mesh)
                return {**_tree_histograms(grads, "grad_hist", bins),
                        **_tree_histograms(full, "param_hist", bins)}

        return hist_fn

    # ---------------- eval forward (phase 1 & 2) ----------------
    def _interacted(self, graphone: GraphONE, aux: Sequence[str],
                    feat: torch.Tensor, banks: Banks, train: bool,
                    generator: Optional[torch.Generator]
                    ) -> Dict[str, torch.Tensor]:
        """The aux heads' projections of the backbone features, detached
        (reference main_egopack.py:53), interacted with the prototype banks;
        returned as ``(B, N, F)`` per aux task."""
        flat = feat.reshape(-1, feat.shape[-1])
        with torch.no_grad():
            secondary = {t: self.tasks[t].head.forward_features(
                flat, train, generator) for t in aux}
        inter, _ = graphone.interact(secondary,
                                     _effective_banks(self.model, banks))
        return {t: v.reshape(feat.shape[0], feat.shape[1], -1)
                for t, v in inter.items()}

    def make_eval_step(self, name: str, aux: Tuple[str, ...] = (),
                       graphone: Optional[GraphONE] = None,
                       late_fusion: bool = True):
        """Eval forward for one task, with the optional GraphONE interaction
        (reference validate.py:33-60):
        ``step(batch, banks) -> (logits, per_elem, post_feat, node_mask)``.
        ``post_feat`` is the task projection, stacked with the interacted
        aux features when GraphONE runs (validate.py:43,52-56)."""
        head = self.tasks[name].head

        @torch.no_grad()
        def step(batch: Batch, banks: Optional[Banks] = None):
            feat, node_mask = self.backbone_features(batch, name, False, None)
            tfeat = head.forward_features(feat)
            pool_mask = node_mask if name == "oscc" else None
            aux_feats, post_feat = None, tfeat
            if graphone is not None and aux:
                aux_feats = self._interacted(graphone, aux, feat, banks,
                                             False, None)
                b, n = feat.shape[:2]
                post_feat = torch.stack(
                    [tfeat.reshape(b * n, -1)]
                    + [v.reshape(b * n, -1) for v in aux_feats.values()],
                    dim=1).reshape(b, n, -1)
            if late_fusion or aux_feats is None:
                logits = head.forward_logits(tfeat, pool_mask,
                                             aux_features=aux_feats)
            else:
                # early fusion: max over the stacked primary and aux
                # features (validate.py:49)
                mixed = torch.stack([tfeat, *aux_feats.values()],
                                    dim=1).amax(1)
                logits = head.forward_logits(mixed, pool_mask)
            per_elem = _phase2_task_loss(head, logits, batch["y"])
            return logits, per_elem, post_feat, node_mask

        return step

    # ---------------- phase 2: EgoPack step ----------------
    def make_egopack_loss_fn(self, active: Tuple[str, ...],
                             graphone: GraphONE,
                             backprop_temporal_graph: bool = True,
                             temporal_graph_train_mode: bool = False,
                             late_fusion: bool = True):
        """The phase-2 loss: ``loss_fn(banks, batches, generator) ->
        (loss, logs)``."""
        all_tasks = tuple(self.tasks)

        def task_loss(banks: Banks, name: str, batch: Batch,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
            feat, node_mask = self.backbone_features(
                batch, name, temporal_graph_train_mode, generator)
            if not backprop_temporal_graph:
                feat = feat.detach()
            head = self.tasks[name].head
            tfeat = head.forward_features(feat, True, generator)
            # without late fusion the JAX step computes the interaction and
            # drops it; nothing of it reaches the loss, so it is skipped
            aux_feats = None
            if late_fusion:
                # interact only with tasks that have prototype banks
                others = tuple(t for t in all_tasks
                               if t != name and t in graphone.task_labels)
                aux_feats = self._interacted(graphone, others, feat, banks,
                                             True, generator)
            logits = head.forward_logits(
                tfeat, node_mask if name == "oscc" else None, True,
                generator, aux_features=aux_feats)
            per_elem = _phase2_task_loss(head, logits, batch["y"])
            mask = batch["valid"] if per_elem.ndim == 1 else node_mask
            return masked_mean(per_elem, mask, self.mesh.data_axis)

        def loss_fn(banks: Banks, batches: Dict[str, Batch],
                    generator: Optional[torch.Generator]):
            total, logs = 0.0, {}
            generator = self.sample_generator(generator)
            for name in active:
                loss = task_loss(banks, name, batches[name], generator)
                logs[f"{name}_loss"] = loss
                total = total + self.tasks[name].weight * loss
            return total, logs

        return loss_fn

    def make_egopack_train_step(self, optimizer: Adam,
                                active: Tuple[str, ...], graphone: GraphONE,
                                backprop_temporal_graph: bool = True,
                                temporal_graph_train_mode: bool = False,
                                late_fusion: bool = True, log_norms=True,
                                per_layer_norms: bool = False):
        """One EgoPack step:
        ``step(opt_state, banks, batches, generator, lr) -> logs``, in
        place like the phase-1 step (``egopack_tpu/train/system.py:
        687-723``)."""
        inner = self._make_inner_step(optimizer, self.make_egopack_loss_fn(
            active, graphone, backprop_temporal_graph,
            temporal_graph_train_mode, late_fusion), per_layer_norms)

        def step(opt_state: AdamState, banks: Banks,
                 batches: Dict[str, Batch],
                 generator: Optional[torch.Generator], lr: float) -> Logs:
            opt_state.hyperparams["learning_rate"] = lr
            return inner(opt_state, (banks, batches, generator), log_norms)

        return step

    def make_egopack_train_step_multi(self, optimizer: Adam,
                                      active: Tuple[str, ...],
                                      graphone: GraphONE, steps_per_call: int,
                                      log_norms=True,
                                      per_layer_norms: bool = False, **kw):
        """``steps_per_call`` EgoPack steps:
        ``multi_step(opt_state, banks, batch_list, generator, lr) -> logs``
        (same stacking and ``log_norms="last"`` as
        ``make_train_step_multi``); ``kw`` as for
        ``make_egopack_train_step``."""
        inner = self._make_inner_step(optimizer, self.make_egopack_loss_fn(
            active, graphone, **kw), per_layer_norms)

        def multi_step(opt_state: AdamState, banks: Banks,
                       batch_list: Sequence[Dict[str, Batch]],
                       generator: Optional[torch.Generator],
                       lr: float) -> Logs:
            opt_state.hyperparams["learning_rate"] = lr
            return self._multi(inner, opt_state,
                               [(banks, batch_list[k], generator)
                                for k in range(steps_per_call)], log_norms)

        return multi_step
