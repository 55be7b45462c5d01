"""Shared temporal-graph backbone (counterpart of
``egopack_tpu/models/backbone.py:TemporalGraph``).

Mirrors the reference ``Graph`` (``models/graph.py:15-65``): pre-dropout ->
TRN pooling -> ``x + net(x + PE(pos))`` where net = depth x [SAGEConv(project)
-> graph-LayerNorm -> LeakyReLU(0.2)] + Linear. Graphs are dense static
in-neighbour masks, and node masks keep padded samples out of the
statistics.

``propagate_dtype`` (``egopack_tpu/models/backbone.py:38-62``): ``None``
keeps float32 activations between layers (bf16 operands only where the
input is bf16); ``bfloat16`` keeps them in bf16 through the pooling, the
SAGE layers and ``out_lin``. The graph LayerNorms compute in float32 and
return the input's dtype, the positional encoding takes the activations'
dtype, and the system casts the backbone's output back to float32 before
the heads.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike
from .layers import (DenseSAGEConv, GraphLayerNorm, TLinear, dropout,
                     positional_encoding, resolve_dtype)
from .pooling import TRNPooling


def _leaky_relu(z: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) as JAX computes it: the slope is rounded to the
    activations' dtype, so under bf16 propagation negative values are
    multiplied by bf16(0.2) = 0.2002, not by 0.2 as ``F.leaky_relu``
    does."""
    if z.dtype != torch.bfloat16:
        return F.leaky_relu(z, 0.2)
    return torch.where(z >= 0, z, z * torch.tensor(0.2, dtype=z.dtype))


class TemporalGraph(nn.Module):
    """Inputs: ``x (B, N, S, D)``, ``adj (N, N) | (B, N, N)`` bool
    in-neighbour mask, ``pos (N,)`` node positions, ``node_mask (B, N)``.
    Output: node features ``(B, N, hidden_size)``. Submodule names follow the
    flax tree: ``pooling``, ``sage{i}``, ``gn{i}``, ``out_lin``."""

    def __init__(self, input_size: int, hidden_size: int = 1024,
                 depth: int = 3, pre_dropout: float = 0.0,
                 temporal_pooling: Optional[nn.Module] = None,
                 num_segments: int = 8, propagate_dtype: Any = None, *,
                 device: DeviceLike = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.depth = depth
        self.pre_dropout = pre_dropout
        self.num_segments = num_segments
        self.propagate_dtype = dtype = resolve_dtype(propagate_dtype)
        self.pooling = temporal_pooling if temporal_pooling is not None else \
            TRNPooling(input_size, hidden_size, num_segments, dtype=dtype,
                       device=device)
        for i in range(depth):
            self.add_module(f"sage{i}", DenseSAGEConv(
                hidden_size, hidden_size, project=True, dtype=dtype,
                device=device))
            self.add_module(f"gn{i}", GraphLayerNorm(hidden_size,
                                                     device=device))
        self.out_lin = TLinear(hidden_size, hidden_size, dtype=dtype,
                               device=device)

    def _layers(self):
        return [(getattr(self, f"sage{i}"), getattr(self, f"gn{i}"))
                for i in range(self.depth)]

    def pool(self, x: torch.Tensor, train: bool = False,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Pre-dropout + temporal pooling: (B, N, S, D) -> (B, N, H). Kept
        apart so the multi-task step can pool every task's nodes in one
        product (the MLP is per node)."""
        x = dropout(x, self.pre_dropout, train, generator)
        return self.pooling(x, train=train, generator=generator)

    def reason(self, h: torch.Tensor, adj: torch.Tensor, pos: torch.Tensor,
               node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """PE + depth x SAGE + global residual (reference graph.py:60-63)."""
        if self.depth <= 0:
            return h
        pe = positional_encoding(pos, self.hidden_size).to(h.dtype)
        z = h + pe if pe.ndim == h.ndim else h + pe[None]
        for conv, norm in self._layers():
            z = _leaky_relu(norm(conv(z, adj), node_mask))
        return h + self.out_lin(z)

    def reason_multi(self, hs: Sequence[torch.Tensor],
                     adjs: Sequence[torch.Tensor],
                     poss: Sequence[torch.Tensor],
                     node_masks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``reason`` for several task branches at once: the per-node products
        of every layer run once over all branches (``DenseSAGEConv.multi``);
        aggregation and the graph-mode LayerNorm stay per branch."""
        if self.depth <= 0:
            return list(hs)
        zs = [h + positional_encoding(p, self.hidden_size).to(h.dtype)[None]
              for h, p in zip(hs, poss)]
        for conv, norm in self._layers():
            zs = conv.multi(zs, adjs)
            zs = [_leaky_relu(norm(z, m)) for z, m in zip(zs, node_masks)]
        sizes = [(z.shape[0], z.shape[1]) for z in zs]
        flat = torch.cat([z.reshape(1, -1, z.shape[-1]) for z in zs], 1)
        out_flat = self.out_lin(flat)
        outs, off = [], 0
        for (b, n), h in zip(sizes, hs):
            outs.append(h + out_flat[0, off:off + b * n].reshape(b, n, -1))
            off += b * n
        return outs

    def reason_concat(self, h: torch.Tensor, adj_cc: torch.Tensor,
                      pos_cc: torch.Tensor, mask_cc: torch.Tensor,
                      task_onehot: torch.Tensor) -> torch.Tensor:
        """``reason`` over the CONCATENATED node set of several branches:
        block-diagonal aggregation and task-onehot LN statistics on one
        ``(1, M, H)`` layout; the caller splits per task once, at the end.

        h (1, M, H); adj_cc (M, M) bool; pos_cc (M,); mask_cc (M,) bool;
        task_onehot (T, M) float."""
        if self.depth <= 0:
            return h
        z = h + positional_encoding(pos_cc, self.hidden_size).to(h.dtype)[None]
        for conv, norm in self._layers():
            z = _leaky_relu(norm(conv.concat(z, adj_cc), mask_cc,
                                 task_onehot))
        return h + self.out_lin(z)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, pos: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.reason(self.pool(x, train, generator), adj, pos, node_mask)
