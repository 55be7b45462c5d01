"""Loss functions with the reference's reduction semantics
(counterpart of ``egopack_tpu/ops/losses.py``).

All functions return per-element losses (reduction='none'); ignored entries
(label -1) contribute exactly 0, and the training mean divides by ALL
elements, ignored ones included, because the reference calls ``.mean()`` on
the masked-out loss vector (reference main_temporal.py:99,128). AR labels only
the centre node of 9, so that 1/N scale matters for the trajectory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.collectives import SINGLE, Axis, all_reduce_


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """CE with ignore_index and optional label smoothing
    (``(1-e)*NLL + e*mean_c(-log p_c)``). logits (..., C), labels (...)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ignored = labels == ignore_index
    safe = torch.where(ignored, 0, labels).long()
    nll = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    if label_smoothing > 0.0:
        smooth = -logp.mean(-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return torch.where(ignored, 0.0, nll)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy on logits (reduction='none')."""
    logits = logits.float()
    targets = targets.float()
    return (torch.clamp_min(logits, 0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.5, gamma: float = 2.0) -> torch.Tensor:
    """torchvision ``sigmoid_focal_loss`` semantics (reduction='none'), used
    by the OSCC head (reference models/tasks/oscc.py:96)."""
    p = torch.sigmoid(logits.float())
    targets = targets.float()
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return loss


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                axis: Axis = SINGLE) -> torch.Tensor:
    """Mean over elements where mask is True. It excludes PADDED samples,
    never ignore-labelled nodes: those stay in the denominator.

    With ``axis`` (the data axis of a batch split over ranks) the count is
    that of the whole axis (``egopack_tpu/ops/losses.py:51-56``): this
    rank's share of the global batch's mean, which summed over the axis is
    that mean."""
    m = mask.float()
    count = all_reduce_(m.sum(), axis)
    return (values.float() * m).sum() / torch.clamp_min(count, 1.0)
