"""Adam with coupled L2 and a trainable mask, and the per-epoch LR schedules
(counterpart of ``egopack_tpu/train/optim.py``).

The reference uses ``torch.optim.Adam``: weight decay is added to the
gradient BEFORE the moment updates (unlike AdamW), and parameters whose
``.grad`` is None are neither decayed nor tracked. The mask names the
trainable parameters; the train step computes gradients for those alone, so
the others keep their values and their moments bit for bit.

``impl="fused"`` updates every trainable leaf through the CUDA kernel of
``ops/fused_adam.py``; ``impl="optax"`` (the JAX default's name) is the plain
per-leaf chain of PyTorch operations with the same math.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Union

import torch

from ..interop import top_level_key
from ..ops.fused_adam import bias_corrections, fused_adam, fused_adam_reference

Params = Dict[str, torch.Tensor]
Mask = Union[None, Dict[str, bool], Callable[[Params], Dict[str, bool]]]
IMPLS = ("optax", "fused")


@dataclass
class AdamState:
    """What the JAX state holds: the injected learning rate, the step count
    and one moment pair per parameter (frozen ones included, never read)."""
    hyperparams: dict
    count: int
    mu: Params
    nu: Params


class Adam:
    """``torch.optim.Adam`` semantics (coupled L2) over a named-parameter
    dict. ``apply`` updates the parameters and moments in place."""

    def __init__(self, lr: float, weight_decay: float, b1: float, b2: float,
                 eps: float, trainable_mask: Mask = None,
                 moments_dtype: str = "float32", impl: str = "optax"):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.lr = lr
        self.weight_decay = float(weight_decay)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.trainable_mask = trainable_mask
        self.m_dtype = getattr(torch, moments_dtype or "float32")
        self.impl = impl

    def trainable_names(self, params: Params) -> List[str]:
        mask = self.trainable_mask
        if callable(mask):
            mask = mask(params)
        if mask is None:
            return list(params)
        return [n for n in params if mask[n]]

    def init(self, params: Params) -> AdamState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.m_dtype, device=p.device)
        return AdamState(hyperparams={"learning_rate": self.lr}, count=0,
                         mu={n: zeros(p) for n, p in params.items()},
                         nu={n: zeros(p) for n, p in params.items()})

    @torch.no_grad()
    def apply(self, grads: Params, state: AdamState, params: Params) -> None:
        """One step over the trainable parameters; ``grads`` holds one
        float32 gradient for each of them."""
        state.count += 1
        bc1, bc2 = bias_corrections(self.b1, self.b2, state.count)
        lr = float(state.hyperparams["learning_rate"])
        names = self.trainable_names(params)
        ps = [params[n] for n in names]
        gs = [grads[n].contiguous() for n in names]
        ms = [state.mu[n] for n in names]
        vs = [state.nu[n] for n in names]
        kw = dict(wd=self.weight_decay, b1=self.b1, b2=self.b2, eps=self.eps)
        if self.impl == "fused":
            fused_adam(ps, gs, ms, vs, lr, bc1, bc2, **kw)
            return
        if not ps:
            return
        bc = torch.tensor([bc1, bc2], dtype=torch.float32,
                          device=ps[0].device)
        for p, g, m, v in zip(ps, gs, ms, vs):
            fused_adam_reference(p, g, m, v, lr, bc[0], bc[1], **kw)


def adam(lr: float = 1e-5, weight_decay: float = 0.0, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8, trainable_mask: Mask = None,
         moments_dtype: str = "float32", impl: str = "optax") -> Adam:
    """``torch.optim.Adam`` equivalent (coupled L2 weight decay).

    ``trainable_mask``: dict or callable giving ``{name: bool}``; None trains
    every parameter. ``moments_dtype``: "float32" or "bfloat16" (moments
    stored rounded, arithmetic in float32). ``impl``: "optax" or "fused"."""
    return Adam(lr, weight_decay, b1, b2, eps, trainable_mask, moments_dtype,
                impl)


def trainable_mask_fn(trainable_keys: Iterable[str]
                      ) -> Callable[[Params], Dict[str, bool]]:
    """Mask for torch's grad=None semantics: only the top-level subtrees
    (``temporal_graph``, ``task/recognition``, ...) that appear in the loss
    graph are optimised (counterpart of ``train/driver.py:trainable_mask_fn``)."""
    keys = set(trainable_keys)

    def fn(params: Params) -> Dict[str, bool]:
        return {n: top_level_key(n) in keys for n in params}

    return fn


def cosine_annealing(T_max: int, eta_min: float = 0.0
                     ) -> Callable[[int, float], float]:
    """torch CosineAnnealingLR: lr(e) after e scheduler steps."""

    def schedule(epochs_completed: int, base_lr: float) -> float:
        return eta_min + (base_lr - eta_min) * (
            1 + math.cos(math.pi * epochs_completed / T_max)) / 2

    return schedule


def linear_warmup(start_factor: float = 0.001, end_factor: float = 1.0,
                  total_iters: int = 5) -> Callable[[int], float]:
    """torch LinearLR factor after e scheduler steps."""

    def factor(epochs_completed: int) -> float:
        t = min(epochs_completed, total_iters)
        return start_factor + (end_factor - start_factor) * t / total_iters

    return factor


def build_lr_fn(base_lr: float,
                scheduler: Optional[Callable[[int, float], float]],
                use_warmup: bool = False) -> Callable[[int], float]:
    """Per-epoch LR: chained warmup x cosine, both stepped every epoch
    (torch ChainedScheduler semantics, reference main_temporal.py:275-279)."""
    warm = linear_warmup() if use_warmup else None

    def lr_fn(epochs_completed: int) -> float:
        lr = base_lr
        if scheduler is not None:
            lr = scheduler(epochs_completed, base_lr)
        if warm is not None:
            lr = lr * warm(epochs_completed)
        return lr

    return lr_fn
