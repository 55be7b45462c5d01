"""Criterion selection over multi-label logits (the port's counterpart of
``egopack_tpu/ops/criterion.py``; reference ``criterion/wrapper.py:11-82``).

A dataset may label each sample with several separate labels (verb, noun)
and optionally a joint one (EK100 actions). ``MetricSelectorWrapper`` routes
a base criterion over the tuple of logits:

- joint label present and ``joint_label_training``: the joint head only;
- joint label present, flag off: every head but the joint one, summed;
- no joint label (Ego4D): every head, summed per sample.
"""

from __future__ import annotations

import logging
from typing import Callable, Sequence

import torch

from .losses import cross_entropy

logger = logging.getLogger(__name__)


class MetricSelectorWrapper:
    """``wrapper(logits_tuple, targets) -> per-element loss``;
    ``criterion(logits, labels)`` gives a per-element loss, by default
    cross-entropy that ignores -1 (the reference always wraps
    ``CrossEntropyLoss(reduction='none', ignore_index=-1)``,
    main_temporal.py:287-296)."""

    def __init__(self, criterion: Callable = cross_entropy, dataset=None,
                 joint_label_training: bool = False):
        if dataset is not None and not dataset.has_joint_label \
                and joint_label_training:
            logger.warning("joint_label_training=True but the dataset has no "
                           "joint label")
            joint_label_training = False
        self.criterion = criterion
        self.dataset = dataset
        self.joint_label = joint_label_training

    def __call__(self, logits: Sequence[torch.Tensor],
                 targets: torch.Tensor) -> torch.Tensor:
        num_labels = targets.shape[-1]
        if len(logits) != num_labels:
            raise ValueError("The number of predictions must match the number "
                             "of ground truth labels")
        if self.dataset is not None and self.dataset.has_joint_label:
            heads = ([num_labels - 1] if self.joint_label
                     else range(num_labels - 1))
        else:
            heads = range(num_labels)
        return torch.stack([self.criterion(logits[i], targets[..., i])
                            for i in heads]).sum(0)
