"""Frame-index samplers for clip features (the port's copy of
``egopack_tpu/data/sampling.py``).

Semantics match reference data/base_dataset.py:128-155 exactly (golden
tests pin them): ``random_sampling_indices`` places n jittered strided indices,
``uniform_sampling_indices`` places n strided indices offset to segment centers.
These run host-side in the data pipeline (tiny, numpy) — the device never sees
dynamic shapes.
"""

from __future__ import annotations

import numpy as np


def random_sampling_indices(size: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """Jittered strided sampling of ``n`` indices in ``[0, size]``.

    Parity: reference clips to ``size`` (not ``size - 1``) and rounds, so an
    index equal to ``size`` is possible when the jitter lands at the boundary —
    callers slice with ``min(idx, len-1)`` exactly like ``np.take`` on the
    reference path would raise and fall into its zero-fill guard. We reproduce
    the index math verbatim and let the caller apply the same guard.
    """
    average_duration = size // n
    if average_duration > 0:
        indices = np.multiply(list(range(n)), size / n)
        indices = indices + rng.integers(0, average_duration, size=n)
        indices = np.clip(indices, 0, size)
    else:
        indices = np.linspace(0, size, n, endpoint=False, dtype=int)
    return np.round(indices).astype(int)


def uniform_sampling_indices(size: int, n: int) -> np.ndarray:
    offsets = np.linspace(0, size, n, endpoint=False, dtype=int)
    offsets = offsets + (size // n // 2)
    return offsets.astype(int)


def batch_sampling_indices(sizes: np.ndarray, n: int,
                           rng: np.random.Generator | None) -> np.ndarray:
    """Vectorized sampler over A windows at once: ``(A, n)`` indices.

    Row semantics are identical to calling ``random_sampling_indices`` /
    ``uniform_sampling_indices`` per window (the per-row jitter is still
    uniform over ``[0, size // n)``); vectorizing deletes the per-action
    Python/numpy dispatch that dominated the host pipeline at Ego4D scale
    (one sampler + one gather per SAMPLE instead of per action).
    Rows with ``size <= 0`` yield zeros (callers map them to the zero-fill
    guard)."""
    sizes = np.asarray(sizes, np.int64)
    a = len(sizes)
    base = np.arange(n)[None] * (sizes[:, None] / n)  # (A, n) float
    if rng is None:
        off = (sizes // n // 2)[:, None]
        return base.astype(np.int64) + off
    avg = sizes // n
    jitter = rng.integers(0, np.maximum(avg, 1)[:, None], size=(a, n))
    jittered = np.round(np.clip(base + jitter, 0, sizes[:, None]))
    return np.where(avg[:, None] > 0, jittered.astype(np.int64),
                    base.astype(np.int64))


def random_sampling(data: np.ndarray, num_segments: int,
                    rng: np.random.Generator) -> np.ndarray:
    indices = random_sampling_indices(data.shape[0], num_segments, rng)
    return np.take(data, indices, axis=0)


def uniform_sampling(data: np.ndarray, num_segments: int) -> np.ndarray:
    indices = uniform_sampling_indices(data.shape[0], num_segments)
    return np.take(data, indices, axis=0)
