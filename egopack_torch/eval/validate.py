"""Validation loops: the eval forward on the device, the meters on the host
(the port's counterpart of ``egopack_tpu/eval/validate.py``, one process).

Mirrors reference ``validate.py``: ``validate`` (AR, OSCC), ``validate_lta``
(K categorical samples per node) and ``validate_pnr`` (keyframe
localization). The eval step comes from ``MultiTaskSystem.make_eval_step``;
each batch's outputs reach the host in one wait for the device, and the
per-batch loss is the JAX package's numpy masked mean over the fetched
per-element losses. A meter with ``save_features`` also collects each
valid sample's input and projected features for its t-SNE plot.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..data.loader import DeviceCopier, device_prefetch
from .meters import BaseMeter


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """numpy copies of ``tensors`` after a single wait for the device: the
    copies are queued without blocking, then the stream is synchronised
    once."""
    outs = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    cuda = [t.device for t in tensors if t.is_cuda]
    if cuda:
        torch.cuda.current_stream(cuda[0]).synchronize()
    return [o.numpy() for o in outs]


def _node_mask(batch) -> np.ndarray:
    valid = np.asarray(batch["valid"])
    n = batch["y"].shape[1] if batch["y"].ndim > 1 else None
    return np.repeat(valid[:, None], n, 1) if n else valid


def _batch_loss(per_elem: np.ndarray, batch) -> float:
    """``ops.losses.masked_mean`` in numpy over the fetched per-element
    losses (the JAX package's ``_host_masked_mean``)."""
    mask = np.asarray(batch["valid"]) if per_elem.ndim == 1 \
        else _node_mask(batch)
    pe = np.asarray(per_elem, np.float32)
    m = mask.astype(np.float32)
    return float((pe * m).sum() / max(m.sum(), 1.0))


def _pre_features(batch, valid: np.ndarray) -> np.ndarray:
    """The reference's pre-features (validate.py:54-57): the mean over the
    segments of the raw input when ``x`` has a segment axis, else ``x``
    (egopack_tpu/eval/validate.py:_pre_features)."""
    x = np.asarray(batch["x"])[valid]
    return x.mean(-2) if x.ndim == 4 else x


def _fetch(meter: BaseMeter, batch, valid: np.ndarray,
           outputs: List[torch.Tensor], feat: torch.Tensor
           ) -> List[np.ndarray]:
    """``outputs`` on the host in one wait. With ``meter.save_features``
    the projected features ride along and go to the meter with the input's
    (for LTA and PNR too, which the reference's loops leave out,
    validate.py:107,150; the JAX package extends the base convention)."""
    if not meter.save_features:
        return to_host(outputs)
    host = to_host(outputs + [feat])
    meter.update_features(_pre_features(batch, valid), host.pop()[valid])
    return host


def paired_batches(loader, device):
    """(host batch, device batch) pairs, the copies one batch ahead."""
    copier = DeviceCopier(device)
    return device_prefetch(iter(loader), lambda b: (b, copier.put(b)),
                           lambda p: (p[0], copier.ready(p[1])))


def validate(eval_step: Callable, banks, loader, meter: BaseMeter,
             task_name: str, device: torch.device) -> BaseMeter:
    """Task-generic eval (AR, OSCC), reference validate.py:14-60."""
    if task_name not in ("ar", "oscc"):
        raise ValueError(task_name)
    for batch, dbatch in paired_batches(loader, device):
        logits, per_elem, feat, _ = eval_step(dbatch, banks)
        valid = np.asarray(batch["valid"])
        y = np.asarray(batch["y"])
        heads = list(logits) if task_name == "ar" else [logits]
        host = _fetch(meter, batch, valid, heads + [per_elem], feat)
        loss = _batch_loss(host[-1], batch)
        if task_name == "ar":
            v, n = (h[valid].reshape(-1, h.shape[-1]) for h in host[:2])
            meter.update((v, n), y[valid].reshape(-1, 2), loss)
        else:
            meter.update(host[0][valid], y[valid], loss)
    return meter


def validate_lta(eval_step: Callable, banks, loader, meter: BaseMeter,
                 sample_fn: Callable,
                 generator: Optional[torch.Generator],
                 device: torch.device) -> BaseMeter:
    """LTA eval with K=5 categorical samples per node
    (reference validate.py:63-106); ``sample_fn(logits, generator)`` is the
    head's ``generate_from_logits``."""
    for batch, dbatch in paired_batches(loader, device):
        logits, per_elem, feat, _ = eval_step(dbatch, banks)
        preds, logits = sample_fn(logits, generator)
        valid = np.asarray(batch["valid"])
        y = np.asarray(batch["y"])
        host = _fetch(meter, batch, valid,
                      [logits[0], logits[1], preds[0], preds[1], per_elem],
                      feat)
        loss = _batch_loss(host[4], batch)
        flat = [a[valid].reshape((-1,) + a.shape[2:]) for a in host[:4]]
        meter.update((flat[0], flat[1]), y[valid].reshape(-1, 2),
                     (flat[2], flat[3]), loss)
    return meter


def validate_pnr(eval_step: Callable, banks, loader, meter: BaseMeter,
                 device: torch.device) -> BaseMeter:
    """PNR eval with the localization metadata
    (reference validate.py:109-150)."""
    for batch, dbatch in paired_batches(loader, device):
        logits, per_elem, feat, _ = eval_step(dbatch, banks)
        valid = np.asarray(batch["valid"])
        host = _fetch(meter, batch, valid, [logits, per_elem], feat)
        loss = _batch_loss(host[1], batch)
        meter.update(host[0][valid], np.asarray(batch["y"])[valid], loss,
                     start_frame=np.asarray(batch["start_frame"])[valid],
                     end_frame=np.asarray(batch["end_frame"])[valid],
                     pnr_frame=np.asarray(batch["pnr_frame"])[valid])
    return meter
