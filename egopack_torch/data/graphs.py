"""Static temporal-graph structure (numpy; the port's own copy of
``egopack_tpu/data/graphs.py``).

The reference builds per-sample edge lists with ``RadiusGraph(r=k+0.5)`` over
integer positions (reference ``main_temporal.py:168``) and, for LTA, extra
edges from the last ``floor(r)`` input clips to every forecast node
(reference ``models/transforms/lta_temp_connectivity.py:37-56``). Because
every task uses a fixed node count (AR 9, OSCC 4, PNR 16, LTA 22) and integer
chain positions, the edge structure is static per task, except for a
data-dependent quirk in the LTA transform (see
``lta_extra_adjacency_host``).

Graphs are dense in-neighbour masks ``A[t, s] = 1`` iff node ``s`` sends a
message to node ``t``; message passing is a masked matrix product.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class GraphSpec:
    """Static description of one task's temporal graph."""

    name: str
    num_nodes: int
    pos: np.ndarray  # (N,) float: node positions fed to the positional encoding
    adjacency: np.ndarray  # (N, N) bool in-neighbour mask (radius graph part)
    lta_extra: bool = False  # whether LTA forecast edges are added per sample
    radius: float = 1.5
    num_input_clips: int = 0


def radius_adjacency(pos: np.ndarray, r: float) -> np.ndarray:
    """Dense equivalent of ``radius_graph(pos, r, loop=False)``: symmetric
    in-neighbour mask over integer positions."""
    pos = np.asarray(pos, dtype=np.float64).reshape(-1)
    d = np.abs(pos[:, None] - pos[None, :])
    return (d <= r) & ~np.eye(len(pos), dtype=bool)


def ar_spec(window_size: int = 9, k: float = 1.0) -> GraphSpec:
    # AR positions are centred: arange(window) - window//2
    # (reference data/ego4d_fho.py:224)
    pos = np.arange(window_size, dtype=np.float32) - window_size // 2
    return GraphSpec("ar", window_size, pos, radius_adjacency(pos, k + 0.5),
                     radius=k + 0.5)


def oscc_spec(k: float = 1.0) -> GraphSpec:
    pos = np.arange(4, dtype=np.float32)  # reference data/ego4d_oscc.py:223
    return GraphSpec("oscc", 4, pos, radius_adjacency(pos, k + 0.5),
                     radius=k + 0.5)


def pnr_spec(num_segments: int = 16, k: float = 1.0) -> GraphSpec:
    pos = np.arange(num_segments, dtype=np.float32)
    return GraphSpec("pnr", num_segments, pos, radius_adjacency(pos, k + 0.5),
                     radius=k + 0.5)


def lta_spec(num_input_clips: int = 2, num_forecast_clips: int = 20,
             k: float = 1.0) -> GraphSpec:
    n = num_input_clips + num_forecast_clips
    pos = np.arange(n, dtype=np.float32)
    return GraphSpec("lta", n, pos, radius_adjacency(pos, k + 0.5),
                     lta_extra=True, radius=k + 0.5,
                     num_input_clips=num_input_clips)


def lta_extra_adjacency_host(spec: GraphSpec, y_verb: np.ndarray) -> np.ndarray:
    """Reference-semantics LTA forecast edges for one sample.

    Quirk kept from the reference transform (lta_temp_connectivity.py:49-55):
    the number of forecast targets is ``(y[:, 0] > 0).sum()``, strictly
    positive, so forecast clips whose verb label is 0 shrink the target range.
    Sources are the last ``floor(r)`` input clips (count of ``y[:, 0] == -1``);
    edges are directed source to target only.
    """
    n = spec.num_nodes
    adj = np.zeros((n, n), dtype=bool)
    num_input = int((y_verb == -1).sum())
    num_forecast = int((y_verb > 0).sum())
    src_lo = max(math.ceil(num_input - spec.radius), 0)
    for s in range(src_lo, num_input):
        for t in range(num_input, min(num_input + num_forecast, n)):
            adj[t, s] = True
    return adj
