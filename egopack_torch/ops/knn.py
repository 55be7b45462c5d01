"""Prototype k-NN (counterpart of ``egopack_tpu/ops/knn.py``).

The k nearest valid prototypes of every feature row, for all T tasks in one
call: features ``(T, M, F)``, banks ``(T, P, F)``, masks ``(T, P)``. The
cosine distance goes through the CUDA kernel of ``ops/knn_topk.py`` on the
card; the l2 distance has no kernel in the JAX package and stays plain
PyTorch on every device. Nothing here is differentiable: the reference
computes its edges under ``torch.no_grad`` (graphONE.py:119-141), the JAX
package under ``stop_gradient``.

Banks split by row over the model axis (``axis``): each rank finds the k
nearest among its own rows (the kernel on the card), offsets the indices
by its first row, and the ``(T, M, k)`` partial results of the axis are
gathered and merged to the global k smallest, ties to the lower global
index: the replicated bank's answer (the JAX mesh's ``xla`` path,
``egopack_tpu/train/driver.py:600-605``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.collectives import SINGLE, Axis, all_gather
from .knn_topk import cosine_knn, cosine_knn_reference

IMPLS = ("auto", "cuda", "plain")


def cosine_dissimilarity(features: torch.Tensor,
                         bank: torch.Tensor) -> torch.Tensor:
    """``1 - f̂ @ b̂ᵀ`` (graphONE.py:152-155); (..., M, F), (..., P, F) ->
    (..., M, P)."""
    f = features / torch.linalg.vector_norm(features, dim=-1, keepdim=True)
    b = bank / torch.linalg.vector_norm(bank, dim=-1, keepdim=True)
    return 1.0 - f @ b.transpose(-1, -2)


def l2_distance(features: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Euclidean distance / 4096 (graphONE.py:127,148-149), in the exact
    pairwise form the reference asks for
    (``compute_mode="donot_use_mm_for_euclid_dist"``): the
    ``|a|²+|b|²-2ab`` product form cancels near ties and reorders the
    ranking."""
    d = torch.cdist(features.float(), bank.float(),
                    compute_mode="donot_use_mm_for_euclid_dist")
    return d / 4096.0


@torch.no_grad()
def prototype_topk(features: torch.Tensor, bank: torch.Tensor,
                   bank_mask: torch.Tensor, k: int, distance: str = "cosine",
                   impl: str = "auto", axis: Axis = SINGLE
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid prototypes per feature row, ordered by (distance,
    index): ``(indices (T, M, k) int32, distances (T, M, k))``. Unbatched
    ``(M, F)`` / ``(P, F)`` / ``(P,)`` inputs give ``(M, k)`` outputs.
    Masked rows are ``+inf`` candidates: they come last, in index order.

    ``impl`` (cosine only): ``"auto"`` launches the kernel on CUDA tensors
    and takes the plain version on CPU tensors; ``"cuda"`` launches the
    kernel and raises on the CPU; ``"plain"`` takes the plain version.

    ``axis``: ``bank`` and ``bank_mask`` hold this rank's rows of banks
    split evenly by row over the axis; indices are global."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    unbatched = features.ndim == 2
    if unbatched:
        features, bank, bank_mask = features[None], bank[None], bank_mask[None]
    features, bank = features.detach(), bank.detach()
    bank_mask = bank_mask.to(torch.bool)
    if distance == "cosine":
        if impl == "cuda" and features.device.type != "cuda":
            raise RuntimeError("prototype_topk(impl='cuda') needs CUDA "
                               "tensors")
        knn = cosine_knn_reference if impl == "plain" else cosine_knn
        idx, dist = knn(features.float(), bank.float(), bank_mask, k)
    elif distance == "l2":
        d = torch.where(bank_mask[:, None, :], l2_distance(features, bank),
                        torch.inf)
        dist, idx = torch.sort(d, dim=-1, stable=True)
        idx, dist = idx[..., :k].to(torch.int32), dist[..., :k]
    else:
        raise ValueError(f"Unknown distance function: {distance}")
    if axis.size > 1:
        idx, dist = merge_shards(idx + axis.index * bank.shape[1], dist, k,
                                 axis)
    if unbatched:
        return idx[0], dist[0]
    return idx, dist


def merge_shards(idx: torch.Tensor, dist: torch.Tensor, k: int,
                 axis: Axis) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of the axis's partial top-k lists ``(T, M, k)``, each
    ordered by (distance, global index) and holding rows of lower indices
    the lower the rank: gathered in rank order, a stable sort by distance
    keeps that order among equal distances."""
    idx = torch.cat(all_gather(idx, axis), -1)
    dist, order = torch.sort(torch.cat(all_gather(dist, axis), -1), dim=-1,
                             stable=True)
    return (torch.gather(idx, -1, order[..., :k]).to(torch.int32),
            dist[..., :k])
