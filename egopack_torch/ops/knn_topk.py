"""Cosine k nearest valid prototypes: the CUDA kernel ``csrc/knn_topk.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``egopack_tpu/ops/pallas/knn_topk.py``
(``cosine_knn_pallas``, ``_knn_kernel``, ``_row_topk``). For T tasks at once,
features ``(T, M, F)``, bank ``(T, P, F)`` and mask ``(T, P)`` give the k
valid prototypes nearest by ``1 - f̂·b̂ᵀ`` as ``(idx (T, M, k) int32,
dist (T, M, k) f32)``, ordered by (distance, index): ties go to the lower
index, and masked rows are ``+inf`` candidates that keep their own index, so
with fewer than k valid rows the lowest masked indices fill the tail. That is
``lax.top_k`` over the masked distance matrix, the JAX package's ``xla``
path; its Pallas kernel repeats one index in that tail instead.

The kernel streams the bank, never stores the ``(M, P)`` matrix, and runs as
one launch pair per call for all T tasks (pass 1 over P-splits, pass 2 to
merge them). Its products run on the tensor cores as 3xTF32 (three TF32
products for each float32 one) and sum in another order than the plain
version's matrix product, so distances differ by up to a few 1e-6 and
indices may swap where two distances lie within that error. No gradient:
the JAX op is non-differentiable.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import cuda_build

MAX_K = 32       # one list entry per lane; must match kMaxK in csrc/knn_topk.cu
TILE_ROWS = 64   # feature rows per block; must match kRows
TILE_COLS = 64   # bank rows per tile; must match kCols
THREADS = 256    # pass-1 threads per block (8 warps); must match kThreads
BLOCKS_PER_SM = 2  # pass-1 blocks the P-split aims for, per SM


def cosine_knn_reference(features: torch.Tensor, bank: torch.Tensor,
                         mask: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: normalise, ``1 - f̂ @ b̂ᵀ``, masked rows to
    ``+inf``, then a stable ascending sort, whose order is (distance,
    index). ``torch.topk`` states no order among equal values."""
    f = features / torch.linalg.vector_norm(features, dim=-1, keepdim=True)
    b = bank / torch.linalg.vector_norm(bank, dim=-1, keepdim=True)
    d = 1.0 - torch.bmm(f, b.transpose(1, 2))
    d = torch.where(mask[:, None, :], d, torch.inf)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return idx[..., :k].to(torch.int32), dist[..., :k]


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cuda_build.load("knn_topk")
    fn = lib.egopack_cosine_knn
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = i32
        fn.argtypes = [ptr, ptr, ptr] + [i32] * 6 + [ptr] * 5
        lib.egopack_knn_error_string.restype = ctypes.c_char_p
        lib.egopack_knn_error_string.argtypes = [i32]
    return lib


def _check(features: torch.Tensor, bank: torch.Tensor, mask: torch.Tensor,
           k: int) -> None:
    if features.ndim != 3 or bank.ndim != 3 or mask.ndim != 2:
        raise ValueError("cosine_knn: features (T, M, F), bank (T, P, F) and "
                         "mask (T, P) expected")
    t, _, f = features.shape
    if bank.shape[0] != t or bank.shape[2] != f or \
            tuple(mask.shape) != tuple(bank.shape[:2]):
        raise ValueError(f"cosine_knn: shapes {tuple(features.shape)}, "
                         f"{tuple(bank.shape)}, {tuple(mask.shape)} differ")
    if features.dtype != torch.float32 or bank.dtype != torch.float32:
        raise TypeError("cosine_knn: features and bank must be float32")
    if mask.dtype != torch.bool:
        raise TypeError("cosine_knn: mask must be bool")
    if not 1 <= k <= min(MAX_K, bank.shape[1]):
        raise ValueError(f"cosine_knn: k={k} must lie in [1, min({MAX_K}, "
                         f"P={bank.shape[1]})]; the kernel keeps at most "
                         f"{MAX_K} neighbours")
    if not (features.device == bank.device == mask.device):
        raise ValueError("cosine_knn: tensors on different devices")


def num_splits(t: int, m: int, p: int, sm_count: int) -> int:
    """P-splits of pass 1: enough blocks for ``BLOCKS_PER_SM`` per SM, every
    split owning at least one tile."""
    tiles = -(-p // TILE_COLS)
    want = -(-BLOCKS_PER_SM * sm_count // (t * -(-m // TILE_ROWS)))
    per_split = -(-tiles // max(1, min(want, tiles)))
    return -(-tiles // per_split)


def cosine_knn(features: torch.Tensor, bank: torch.Tensor, mask: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid prototypes for every task; see the module docstring.

    On CUDA tensors it launches the kernel pair and adds one to
    ``cosine_knn.launches``; a failed launch raises. Tensors on the CPU take
    :func:`cosine_knn_reference`, because no kernel runs there."""
    _check(features, bank, mask, k)
    device = features.device
    if device.type == "cpu":
        return cosine_knn_reference(features, bank, mask, k)
    if device.type != "cuda":
        raise ValueError(f"cosine_knn: no kernel for device {device}")
    lib = load_library()
    features, bank, mask = (x.contiguous() for x in (features, bank, mask))
    t, m, f = features.shape
    p = bank.shape[1]
    splits = num_splits(t, m, p, torch.cuda.get_device_properties(
        device).multi_processor_count)
    part_d = torch.empty((t, m, splits, k), dtype=torch.float32, device=device)
    part_i = torch.empty((t, m, splits, k), dtype=torch.int32, device=device)
    idx = torch.empty((t, m, k), dtype=torch.int32, device=device)
    dist = torch.empty((t, m, k), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.egopack_cosine_knn(
            features.data_ptr(), bank.data_ptr(), mask.data_ptr(), t, m, p, f,
            k, splits, part_d.data_ptr(), part_i.data_ptr(), idx.data_ptr(),
            dist.data_ptr(), stream)
    if err != 0:
        msg = lib.egopack_knn_error_string(err).decode()
        raise RuntimeError(f"cosine_knn kernel launch failed: {msg}")
    cosine_knn.launches += 1
    return idx, dist


cosine_knn.launches = 0


def near_tie_swaps(idx: torch.Tensor, dist: torch.Tensor,
                   ref_idx: torch.Tensor, ref_dist: torch.Tensor,
                   atol: float = 1e-5) -> int:
    """Hold a top-k result against a reference that summed in another order.

    Distances must agree within ``atol`` position by position (``+inf``
    with ``+inf``). Indices must agree, except at a near-tie: where the
    result's index sits at another position of the reference row whose
    distance lies within ``atol`` of this position's, or, at the edge of the
    list, where it is not in the reference row but its distance lies within
    ``atol`` of the reference's k-th. Returns the number of positions that
    differ by such a swap; raises ``AssertionError`` on anything else."""
    a_i, a_d = idx.cpu().numpy(), dist.cpu().numpy()
    r_i, r_d = ref_idx.cpu().numpy(), ref_dist.cpu().numpy()
    if a_i.shape != r_i.shape or a_d.shape != r_d.shape:
        raise AssertionError(f"shapes {a_i.shape} and {r_i.shape} differ")
    both_inf = np.isinf(a_d) & np.isinf(r_d) & (a_d == r_d)
    with np.errstate(invalid="ignore"):  # inf - inf, caught by both_inf
        bad_d = ~both_inf & ~(np.abs(a_d - r_d) <= atol)
    if bad_d.any():
        at = tuple(np.argwhere(bad_d)[0])
        raise AssertionError(f"distance at {at}: {a_d[at]!r} against "
                             f"{r_d[at]!r} (atol {atol})")
    k = a_i.shape[-1]
    a_i, a_d = a_i.reshape(-1, k), a_d.reshape(-1, k)
    r_i, r_d = r_i.reshape(-1, k), r_d.reshape(-1, k)
    swaps = 0
    for row, j in np.argwhere(a_i != r_i):
        hit = np.flatnonzero(r_i[row] == a_i[row, j])
        if hit.size:
            ok = abs(r_d[row, hit[0]] - r_d[row, j]) <= atol
        else:
            ok = abs(a_d[row, j] - r_d[row, k - 1]) <= atol
        if not ok:
            raise AssertionError(
                f"row {row} position {j}: index {a_i[row, j]} against "
                f"{r_i[row, j]} with no near-tie (result {a_i[row]}, "
                f"reference {r_i[row]}, distances {r_d[row]})")
        swaps += 1
    return swaps
