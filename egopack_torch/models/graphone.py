"""GraphONE: cross-task prototype banks and the k-NN interaction
(counterpart of ``egopack_tpu/models/graphone.py``).

- ``build_prototypes``: class-averaged task features over the AR train set
  (reference graphone.py:17-63): a segment sum over the joint
  ``verb*n_nouns+noun`` label by ``index_add_`` on the device, float64
  accumulation on the device (summed over the data axis when the sweep is
  split over it), the bank padded to a multiple of 128 with a validity
  mask.
- ``GraphONE``: per-task frozen prototype banks and ``depth`` SAGE stages
  with max aggregation and no bias (reference graphONE.py:13-141), all T
  tasks in one batched product per stage.

Parity notes carried from the JAX package (load-bearing):

- the banks are never updated across depths, and the k-NN edges come from
  the ORIGINAL features at every depth, so they are computed once;
- a feature node aggregates ``max(k prototypes, itself-current)``;
- the bincount is inflated by ``n_tasks`` (the reference appends the label
  batch once per task), scaling every prototype by ``1/n_tasks``;
- ``dropout``, ``output_dropout`` and ``output_projection`` are accepted
  and ignored, as the reference's ``**kwargs`` swallows them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..device import DeviceLike, resolve_device
from ..ops import gemm
from ..ops.knn import prototype_topk
from ..parallel.collectives import SINGLE, Axis, all_reduce_, reduce_from


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PrototypeBank:
    """Static-shape prototype bank: padded rows ``values (P_pad, F)`` and a
    validity ``mask (P_pad,)`` (bool), both tensors on one device."""

    def __init__(self, values: torch.Tensor, mask: torch.Tensor):
        self.values = values
        self.mask = mask

    @property
    def num_valid(self) -> int:
        return int(self.mask.sum())


def finalize_prototypes(sums: Dict[str, np.ndarray], counts: np.ndarray,
                        pad_multiple: int = 128,
                        device: DeviceLike = None) -> Dict[str, PrototypeBank]:
    """Divide the per-class sums by the counts on the host (float64), drop
    never-seen (verb, noun) combos and pad to a multiple of
    ``pad_multiple``, at least one multiple (reference graphone.py:55-61).
    ``counts`` is the n_tasks-inflated bincount."""
    dev = resolve_device(device)
    counts = np.asarray(counts)
    seen = counts > 0
    p = int(seen.sum())
    p_pad = max(_round_up(p, pad_multiple), pad_multiple)
    banks = {}
    for task, s in sums.items():
        s = np.asarray(s)
        padded = np.zeros((p_pad, s.shape[1]), np.float32)
        padded[:p] = (s[seen] / counts[seen, None]).astype(np.float32)
        mask = np.zeros(p_pad, bool)
        mask[:p] = True
        banks[task] = PrototypeBank(torch.as_tensor(padded, device=dev),
                                    torch.as_tensor(mask, device=dev))
    return banks


class GraphONE(nn.Module):
    """Cross-task prototype interaction over all T tasks at once.

    Parameters keep the flax names and layout, with a leading
    ``(depth, T, ...)``: ``w_l``, ``w_r (depth, T, F, H)``,
    ``ln_scale``, ``ln_bias (depth, T, H)``, ``w_proj (depth, T, H, F)``,
    ``b_proj (depth, T, F)``; ``T`` is 1 with ``share_params``. Banks are
    inputs; with ``freeze`` no gradient reaches them
    (``nn.Embedding.from_pretrained(freeze=True)``, graphONE.py:46-49).

    ``knn_impl`` goes to :func:`prototype_topk` (``"auto"``, ``"cuda"`` or
    ``"plain"``).

    ``model_axis``: the banks hold this rank's rows of banks split by row
    over the axis. The k nearest are merged over it, and each neighbour
    row comes from the rank that holds it: every rank contributes its own
    rows and zeros elsewhere, summed over the axis, so the gradient of a
    trained bank reaches its rows on their own rank."""

    model_axis: Axis = SINGLE

    def __init__(self, task_labels: Tuple[str, ...], features_size: int = 1024,
                 hidden_size: int = 1024, freeze: bool = True, k: int = 8,
                 depth: int = 3, distance_func: str = "cosine",
                 residual: bool = False, mix_strategy: str = "max",
                 update_edges_interval: int = 1, share_params: bool = False,
                 knn_impl: str = "auto", dropout: float = 0.0,
                 output_dropout: float = 0.0, output_projection: bool = True,
                 *, device: DeviceLike = None):
        super().__init__()
        del mix_strategy, update_edges_interval  # edges are computed once
        del dropout, output_dropout, output_projection  # ignored, see above
        dev = resolve_device(device)
        self.task_labels = tuple(task_labels)
        self.features_size = features_size
        self.hidden_size = hidden_size
        self.freeze = freeze
        self.k = k
        self.depth = depth
        self.distance_func = distance_func
        self.residual = residual
        self.share_params = share_params
        self.knn_impl = knn_impl
        t = 1 if share_params else len(self.task_labels)
        d, f, h = depth, features_size, hidden_size

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        self.w_l = zeros(d, t, f, h)
        self.w_r = zeros(d, t, f, h)
        self.ln_scale = nn.Parameter(torch.ones(d, t, h, device=dev))
        self.ln_bias = zeros(d, t, h)
        self.w_proj = zeros(d, t, h, f)
        self.b_proj = zeros(d, t, f)
        self._row_indices: Dict[tuple, torch.Tensor] = {}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Torch Linear default init per stage, U(+-1/sqrt(fan_in)), drawn
        from ``generator``; the LN affine is ones and zeros."""
        for w, fan_in in ((self.w_l, self.features_size),
                          (self.w_r, self.features_size),
                          (self.w_proj, self.hidden_size),
                          (self.b_proj, self.hidden_size)):
            bound = 1.0 / math.sqrt(fan_in)
            w.uniform_(-bound, bound, generator=generator)
        self.ln_scale.fill_(1.0)
        self.ln_bias.zero_()

    def _task_rows(self, tasks: Tuple[str, ...]) -> Tuple[int, ...]:
        if self.share_params:
            return tuple(0 for _ in tasks)
        return tuple(self.task_labels.index(t) for t in tasks)

    def _row_index(self, rows_t: Tuple[int, ...]) -> torch.Tensor:
        """``rows_t`` as an index on the parameters' device, made once: a
        copy from the host cannot be captured into a CUDA graph."""
        key = (rows_t, self.w_l.device)
        rows = self._row_indices.get(key)
        if rows is None:
            rows = self._row_indices[key] = torch.as_tensor(
                rows_t, device=self.w_l.device)
        return rows

    def interact(self, features: Dict[str, torch.Tensor],
                 banks: Dict[str, PrototypeBank]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """k-NN message passing over every task in ``features`` (flat
        ``(M, F)`` node batches, one M for all). Returns (updated features,
        closest-prototype index per row), both keyed by task."""
        tasks = tuple(features)
        rows_t = self._task_rows(tasks)
        # in the phase-2 step the tasks ARE task_labels, in order: the
        # per-depth row gather is the identity and is skipped
        identity = (not self.share_params
                    and rows_t == tuple(range(len(self.task_labels))))
        rows = None if identity else self._row_index(rows_t)

        def pick(w: torch.Tensor, d: int) -> torch.Tensor:
            return w[d] if identity else w[d].index_select(0, rows)

        f_stack = torch.stack([features[t] for t in tasks])        # (T, M, F)
        bank_vals = torch.stack([banks[t].values for t in tasks])  # (T, P, F)
        bank_mask = torch.stack([banks[t].mask for t in tasks])    # (T, P)
        if self.freeze:
            bank_vals = bank_vals.detach()

        idx, _ = prototype_topk(f_stack, bank_vals, bank_mask, self.k,
                                self.distance_func, impl=self.knn_impl,
                                axis=self.model_axis)
        t_ar = torch.arange(len(tasks), device=idx.device)[:, None, None]
        if self.model_axis.size == 1:
            neighbors = bank_vals[t_ar, idx.long()]              # (T, M, k, F)
        else:
            p_loc = bank_vals.shape[1]
            local = idx.long() - self.model_axis.index * p_loc
            own = (local >= 0) & (local < p_loc)
            rows = bank_vals[t_ar, local.clamp(0, p_loc - 1)]
            neighbors = reduce_from(torch.where(own[..., None], rows, 0.0),
                                    self.model_axis)
        nb_max = neighbors.amax(dim=2)                           # (T, M, F)

        cur = f_stack
        for d in range(self.depth):
            agg = torch.maximum(nb_max, cur)
            h = gemm.bmm(agg, pick(self.w_l, d)) + gemm.bmm(cur,
                                                            pick(self.w_r, d))
            mean = h.mean(-1, keepdim=True)
            var = ((h - mean) ** 2).mean(-1, keepdim=True)
            h = (h - mean) * torch.rsqrt(var + 1e-5)
            h = h * pick(self.ln_scale, d)[:, None] + pick(self.ln_bias,
                                                           d)[:, None]
            h = torch.relu(h)
            out = gemm.bmm(h, pick(self.w_proj, d)) + pick(self.b_proj,
                                                            d)[:, None]
            cur = out + cur if self.residual else out

        return ({t: cur[i] for i, t in enumerate(tasks)},
                {t: idx[i, :, 0] for i, t in enumerate(tasks)})


def make_prototype_step(system, aux_tasks: Tuple[str, ...], n_verbs: int,
                        n_nouns: int) -> Callable:
    """``step(batch) -> (sums {task: (V*N, F) f32}, counts (V*N,))`` over one
    AR batch: the backbone, each aux head's projection, and a segment sum over
    the joint verb*n_nouns+noun label by ``index_add_`` (reference
    graphone.py:38-53). Unlabelled and padded nodes go to an extra segment
    that is dropped."""
    size = n_verbs * n_nouns

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor]):
        feat, node_mask = system.backbone_features(batch, "ar", False, None)
        y = batch["y"]
        m = node_mask & (y[..., 0] != -1)
        labels = torch.where(m, y[..., 0] * n_nouns + y[..., 1], size)
        flat = labels.reshape(-1).long()
        cnt = torch.zeros(size + 1, dtype=torch.int64, device=flat.device)
        cnt.index_add_(0, flat, torch.ones_like(flat))
        sums = {}
        for t in aux_tasks:
            tf = system.tasks[t].head.forward_features(feat).float()
            tf = tf.reshape(-1, tf.shape[-1])
            acc = torch.zeros((size + 1, tf.shape[-1]), dtype=torch.float32,
                              device=tf.device)
            sums[t] = acc.index_add_(0, flat, tf)[:size]
        return sums, cnt[:size]

    return step


def build_prototypes(proto_step: Callable, batches: Iterable[Dict[str,
                                                                 torch.Tensor]],
                     n_verbs: int, n_nouns: int, n_tasks: int,
                     pad_multiple: int = 128,
                     device: Optional[DeviceLike] = None,
                     data_axis: Axis = SINGLE) -> Dict[str, PrototypeBank]:
    """Sweep the AR batches and average the task features per seen
    (verb, noun) combo (reference graphone.py:17-63). Sums accumulate in
    float64 on the batches' device; the bincount is inflated by
    ``n_tasks``. ``data_axis``: each rank swept its own block of every
    batch, and the sums and counts are summed over the axis (on the
    device, which NCCL needs). The banks land on ``device`` (default: the
    device of the batches)."""
    size = n_verbs * n_nouns
    sums: Dict[str, torch.Tensor] = {}
    counts = None
    for batch in batches:
        if device is None:
            device = batch["x"].device
        s, cnt = proto_step(batch)
        if counts is None:
            counts = torch.zeros(size, dtype=torch.float64,
                                 device=cnt.device)
        counts += cnt.double() * n_tasks
        for t, v in s.items():
            acc = sums.setdefault(t, torch.zeros(
                (size, v.shape[-1]), dtype=torch.float64, device=v.device))
            acc += v.double()
    if counts is None:
        raise ValueError("build_prototypes: no batches to sweep")
    host = {t: all_reduce_(v, data_axis).cpu().numpy()
            for t, v in sums.items()}
    return finalize_prototypes(host, all_reduce_(counts, data_axis).cpu()
                               .numpy(), pad_multiple, device)
