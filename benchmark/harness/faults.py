"""Faults planted under a run, to show that the check catches them (the
tests) and to read where the numbers land under each (``calibrate.py``).
Each takes the program's step and returns the step that the run drives."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


class _Wrapped:
    """The step, each call made through ``call(batches)``."""

    def __init__(self, step, call: Callable):
        self._step = step
        self._call = call

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self, batches):
        return self._call(batches)


def unchanged(step):
    """A step that leaves the parameters and Adam's state as they were."""
    step.optimizer.apply = lambda *args, **kwargs: None
    return step


def half_batch(step):
    """Half of every batch left out: the step sees the first half of each
    task's samples, so each mean is taken over them."""
    def call(batches: Dict[str, dict]):
        return step({task: {k: v[:v.shape[0] // 2] for k, v in b.items()}
                     for task, b in batches.items()})
    return _Wrapped(step, call)


def few_frozen(step):
    """A few trainable leaves left where they were, as a wrong trainable
    mask would: GraphONE's in phase 2; in phase 1 the PNR head's, or the
    OSCC head's in a task set without PNR. Their gradients and moments are
    computed as before."""
    if step.cfg["phase"] == 2:
        prefix = "graphone."
    elif "pnr" in step.cfg["tasks"]:
        prefix = "task.pnr."
    else:
        prefix = "task.oscc."
    params = step.system.params()
    names = [n for n in step.trainable_names() if n.startswith(prefix)]

    def call(batches):
        kept = {n: params[n].detach().clone() for n in names}
        logs = step(batches)
        with torch.no_grad():
            for n in names:
                params[n].copy_(kept[n])
        return logs

    return _Wrapped(step, call)


_PATCHED: list = []


def _patch(module, name: str, new) -> None:
    _PATCHED.append((module, name, getattr(module, name)))
    setattr(module, name, new)


def restore() -> None:
    """Undo every patch of the program that a fault made."""
    while _PATCHED:
        module, name, original = _PATCHED.pop()
        setattr(module, name, original)


def _patch_knn(change: Callable):
    """The k-NN's lists changed by ``change(idx, mask) -> idx`` where
    GraphONE receives them."""
    from egopack_torch.models import graphone as module
    original = module.prototype_topk

    def altered(*args, **kwargs):
        idx, dist = original(*args, **kwargs)
        return change(idx.clone(), args[2]), dist

    _patch(module, "prototype_topk", altered)


def knn_altered(step):
    """The k-NN's answer altered where it is produced: the last neighbour
    of every row replaced by the next valid bank row."""
    def change(idx, mask):
        valid = mask.sum(-1, keepdim=True).to(idx.dtype)   # (T, 1)
        idx[..., -1] = (idx[..., -1] + 1) % valid
        return idx
    _patch_knn(change)
    return step


def knn_duplicate(step):
    """The k-NN's answer altered as a faulty merge of partial lists would:
    every row's last neighbour replaced by its first, the distances
    left as they were."""
    def change(idx, mask):
        idx[..., -1] = idx[..., 0]
        return idx
    _patch_knn(change)
    return step


def gather_shifted(step):
    """The loaders' answer altered where it is produced: every feature row
    that the native gather reads is the row after the one asked for."""
    from egopack_torch.io import native
    original = native.gather_rows

    def shifted(src, idx, *args, **kwargs):
        idx = np.where(idx >= 0, np.minimum(idx + 1, src.shape[0] - 1), idx)
        return original(src, idx, *args, **kwargs)

    _patch(native, "gather_rows", shifted)
    return step


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "few_frozen": few_frozen, "knn_altered": knn_altered,
          "knn_duplicate": knn_duplicate, "gather_shifted": gather_shifted}


def tf32(enabled: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
