"""Metric primitives (numpy) replacing the torchmetrics stack (the port's
copy of ``egopack_tpu/eval/metrics.py``).

Each function documents which torchmetrics construct it reproduces, as
configured by the reference meters (reference utils/meters/ego4d.py).
These run host-side on accumulated predictions — identical to the reference's
device→host metric boundary, minus the wandb coupling.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _valid(labels: np.ndarray, ignore_index: int = -1) -> np.ndarray:
    return labels != ignore_index


def topk_accuracy_micro(logits: np.ndarray, labels: np.ndarray, k: int,
                        ignore_index: int = -1) -> float:
    """MulticlassAccuracy(top_k=k, average='micro', ignore_index=-1)."""
    m = _valid(labels, ignore_index)
    if not m.any():
        return 0.0
    logits, labels = logits[m], labels[m]
    topk = np.argpartition(-logits, min(k, logits.shape[1] - 1), axis=1)[:, :k]
    hit = (topk == labels[:, None]).any(1)
    return float(hit.mean())


def per_class_topk_accuracy(logits: np.ndarray, labels: np.ndarray, k: int,
                            num_classes: int, ignore_index: int = -1
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class top-k recall + support (MulticlassAccuracy average=None)."""
    m = _valid(labels, ignore_index)
    logits, labels = logits[m], labels[m]
    acc = np.zeros(num_classes)
    support = np.bincount(labels, minlength=num_classes).astype(np.float64)
    if len(labels):
        topk = np.argpartition(-logits, min(k, logits.shape[1] - 1), axis=1)[:, :k]
        hit = (topk == labels[:, None]).any(1)
        np.add.at(acc, labels, hit.astype(np.float64))
    with np.errstate(invalid="ignore"):
        acc = np.where(support > 0, acc / np.maximum(support, 1), 0.0)
    return acc, support


def macro_accuracy(logits: np.ndarray, labels: np.ndarray, num_classes: int,
                   ignore_index: int = -1) -> float:
    """MulticlassAccuracy(average='macro'): mean per-class recall over classes
    with support (torchmetrics excludes absent classes from the mean)."""
    acc, support = per_class_topk_accuracy(logits, labels, 1, num_classes,
                                           ignore_index)
    present = support > 0
    return float(acc[present].mean()) if present.any() else 0.0


def confusion_matrix(logits: np.ndarray, labels: np.ndarray, num_classes: int,
                     ignore_index: int = -1) -> np.ndarray:
    m = _valid(labels, ignore_index)
    preds = logits[m].argmax(1)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels[m], preds), 1)
    return cm


def top2_confusion(logits: np.ndarray, labels: np.ndarray, num_classes: int,
                   ignore_index: int = -1) -> np.ndarray:
    """Top2ConfusionMatrix (reference utils/confusion.py:9-48): confusion
    over samples where top-1 is wrong but top-2 is right."""
    m = _valid(labels, ignore_index)
    logits, labels = logits[m], labels[m]
    if not len(labels):
        return np.zeros((num_classes, num_classes), np.int64)
    order = np.argsort(-logits, axis=1)
    top1, top2 = order[:, 0], order[:, 1]
    sel = (top1 != labels) & (top2 == labels)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels[sel], top1[sel]), 1)
    return cm


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


def calibration_error(logits: np.ndarray, labels: np.ndarray,
                      n_bins: int = 15, norm: str = "l1",
                      ignore_index: int = -1) -> float:
    """MulticlassCalibrationError: ECE over top-1 confidence bins. The
    reference's "brier_score" is this metric with n_bins=1, norm='l2'
    (reference utils/meters/ego4d.py:53)."""
    m = _valid(labels, ignore_index)
    if not m.any():
        return 0.0
    probs = _softmax(logits[m].astype(np.float64))
    conf = probs.max(1)
    correct = (probs.argmax(1) == labels[m]).astype(np.float64)
    edges = np.linspace(0, 1, n_bins + 1)
    bins = np.clip(np.digitize(conf, edges[1:-1], right=False), 0, n_bins - 1)
    err = 0.0
    total = len(conf)
    for b in range(n_bins):
        sel = bins == b
        if not sel.any():
            continue
        w = sel.sum() / total
        gap = abs(correct[sel].mean() - conf[sel].mean())
        err += w * gap if norm == "l1" else w * gap ** 2
    return float(err if norm == "l1" else np.sqrt(err))


def binary_accuracy(probs: np.ndarray, labels: np.ndarray,
                    threshold: float = 0.5) -> float:
    # strict > like torchmetrics BinaryAccuracy (prob exactly 0.5 — e.g. a
    # zero logit — counts as the NEGATIVE class there)
    return float(((probs > threshold).astype(int) == labels).mean())


def binary_recall(probs: np.ndarray, labels: np.ndarray,
                  threshold: float = 0.5) -> float:
    pos = labels == 1
    if not pos.any():
        return 0.0
    return float((probs[pos] > threshold).mean())


def binary_auroc(probs: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUROC (Mann-Whitney with tie-averaged ranks), matching
    torchmetrics BinaryAUROC."""
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.0
    order = np.argsort(probs, kind="mergesort")
    ranks = np.empty(len(probs), np.float64)
    sorted_p = probs[order]
    i = 0
    r = 1.0
    while i < len(probs):
        j = i
        while j + 1 < len(probs) and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        avg = (r + r + (j - i)) / 2.0
        ranks[order[i:j + 1]] = avg
        r += j - i + 1
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    """Plain Levenshtein distance — matching the ``editdistance`` package the
    reference actually calls (despite its Damerau-Levenshtein docstring,
    reference utils/meters/ego4d.py:399-404)."""
    la, lb = len(a), len(b)
    prev = np.arange(lb + 1)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (np.asarray(b) != a[i - 1])
        for j in range(1, lb + 1):
            cur[j] = min(cur[j - 1] + 1, prev[j] + 1, sub[j - 1])
        prev = cur
    return int(prev[lb])


def sequence_edit_distance(preds: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Best-of-K normalized edit distance per sequence
    (reference utils/meters/ego4d.py:399-409): preds (N, Z, K),
    labels (N, Z); returns (N,) of min_k ED(pred[:, k], label)/Z."""
    n, z, k = preds.shape
    out = np.empty(n)
    for i in range(n):
        out[i] = min(levenshtein(preds[i, :, kk], labels[i]) / z
                     for kk in range(k))
    return out


def multitask_topk_accuracy(preds: Tuple[np.ndarray, ...],
                            targets: Tuple[np.ndarray, ...],
                            top_k: int = 1) -> float:
    """``MultitaskAccuracy`` (reference utils/metrics.py:9-36): a sample
    is correct iff, at some shared rank position ≤ k, EVERY label head is
    correct... precisely: per rank r, count heads correct at rank r; sample
    correct when the per-rank correct counts summed over ranks reach nlabels.

    Reference math: all_correct (k, bs) accumulates per-head top-k hit masks;
    correct = (all_correct.sum(0) >= nlabels)."""
    nlabels = len(preds)
    bs = targets[0].shape[0]
    all_correct = np.zeros((top_k, bs), np.int64)
    for output, label in zip(preds, targets):
        idx = np.argsort(-output, axis=1)[:, :top_k].T  # (k, bs)
        all_correct += (idx == label[None, :])
    correct = (all_correct.sum(0) >= nlabels).sum()
    return float(correct / bs)


def class_filter(preds, targets, keep: Tuple[np.ndarray, ...]):
    """``ClassFilterWrapper._filter`` (reference utils/metrics.py:39-76):
    keep only samples whose target is in ``keep`` for EVERY head."""
    masks = [np.isin(t, k) for t, k in zip(targets, keep)]
    m = np.logical_and.reduce(masks)
    return tuple(p[m] for p in preds), tuple(t[m] for t in targets)


def topk_recall(scores: np.ndarray, labels: np.ndarray, k: int = 5,
                classes: Optional[np.ndarray] = None) -> float:
    """Mean per-class top-k recall over classes present in the labels
    (reference utils/meters/utils.py:30-47)."""
    unique = np.unique(labels)
    if classes is not None:
        unique = np.intersect1d(classes, unique)
    if not len(unique):
        return 0.0
    acc, _ = per_class_topk_accuracy(scores, labels, k, scores.shape[1])
    return float(acc[unique].mean())
