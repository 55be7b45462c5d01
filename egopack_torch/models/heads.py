"""Per-task projection heads: AR, LTA, OSCC, PNR (counterpart of
``egopack_tpu/models/heads.py``).

- shared projection MLP Dropout -> Linear -> LN -> ReLU -> Linear
  (reference ``models/tasks/task.py:17-23``)
- AR/LTA: one (Dropout -> Linear) classifier per label head
- OSCC: masked global max pool over nodes, then a 2-way classifier
- PNR: per-node scalar logit, squeezed
- phase 2: one auxiliary classifier set per EgoPack task; late fusion sums
  (or averages) the stack ``[primary, *aux]`` of logits per head
  (recognition.py:44-57, oscc.py:65-86, pnr.py:62-74); ``compute_loss``
  gives each head's phase-2 criterion per element

Submodule names follow the flax tree (``proj_fc0``, ``proj_ln``,
``proj_fc1``, ``cls{i}/TLinear_0``, ``cls/TLinear_0``, ``aux_{t}_cls{i}``,
``aux_{t}_cls``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike
from ..ops.losses import bce_with_logits, cross_entropy, sigmoid_focal_loss
from .layers import LayerNorm, TLinear, dropout, uniform

AuxFeatures = Optional[Dict[str, torch.Tensor]]


class _Classifier(nn.Module):
    """Dropout -> Linear classifier head (reference _build_classifier)."""

    def __init__(self, in_features: int, out_features: int,
                 dropout: float = 0.0, *, device: DeviceLike = None):
        super().__init__()
        self.dropout = dropout
        self.TLinear_0 = TLinear(in_features, out_features, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.TLinear_0(dropout(x, self.dropout, train, generator))


class ProjectionTask(nn.Module):
    """Base projection MLP shared by all task heads."""

    def __init__(self, name_: str = "task", input_size: int = 1024,
                 features_size: int = 1024, dropout: float = 0.0, *,
                 device: DeviceLike = None):
        super().__init__()
        self.task_name = name_
        self.features_size = features_size
        self.dropout = dropout
        self.proj_fc0 = TLinear(input_size, features_size, device=device)
        self.proj_ln = LayerNorm(features_size, device=device)
        self.proj_fc1 = TLinear(features_size, features_size, device=device)

    def project(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(x, self.dropout, train, generator)
        x = torch.relu(self.proj_ln(self.proj_fc0(x)))
        return self.proj_fc1(x)

    def forward_features(self, x: torch.Tensor, train: bool = False,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        return self.project(x, train, generator)


def _fuse(stacked: torch.Tensor, average: bool) -> torch.Tensor:
    return stacked.mean(0) if average else stacked.sum(0)


class RecognitionTask(ProjectionTask):
    """AR: multi-head (verb, noun) classification."""

    def __init__(self, name_: str = "ar", input_size: int = 1024,
                 features_size: int = 1024, dropout: float = 0.0,
                 heads: Sequence[int] = (1, 1), head_dropout: float = 0.0,
                 aux_tasks: Optional[Sequence[str]] = None,
                 average_logits: bool = False, *, device: DeviceLike = None):
        super().__init__(name_, input_size, features_size, dropout,
                         device=device)
        self.num_heads = len(heads)
        self.aux_tasks = tuple(aux_tasks or ())
        self.average_logits = average_logits
        for i, h in enumerate(heads):
            self.add_module(f"cls{i}", _Classifier(features_size, h,
                                                   head_dropout, device=device))
        for t in self.aux_tasks:
            for i, h in enumerate(heads):
                self.add_module(f"aux_{t}_cls{i}", _Classifier(
                    features_size, h, head_dropout, device=device))

    def forward_logits(self, features: torch.Tensor,
                       node_mask: Optional[torch.Tensor] = None,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       aux_features: AuxFeatures = None
                       ) -> Tuple[torch.Tensor, ...]:
        del node_mask
        logits = tuple(getattr(self, f"cls{i}")(features, train, generator)
                       for i in range(self.num_heads))
        if aux_features is not None:
            aux = [self.forward_aux_logits(f, t, train, generator)
                   for t, f in aux_features.items()]
            logits = tuple(_fuse(torch.stack([primary, *per_task]),
                                 self.average_logits)
                           for primary, *per_task in zip(logits, *aux))
        return logits

    def forward_aux_logits(self, features: torch.Tensor, task: str,
                           train: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"aux_{task}_cls{i}")(features, train,
                                                         generator)
                     for i in range(self.num_heads))

    def compute_loss(self, logits: Sequence[torch.Tensor],
                     targets: torch.Tensor) -> torch.Tensor:
        """Sum of per-head CE (ignore -1); targets (..., num_heads)."""
        return torch.stack([cross_entropy(l, targets[..., i])
                            for i, l in enumerate(logits)]).sum(0)


class LTATask(RecognitionTask):
    """LTA: per-node (verb, noun) heads + categorical sequence sampling
    (reference lta.py:10-74)."""

    @staticmethod
    def generate_from_logits(logits: Sequence[torch.Tensor],
                             generator: Optional[torch.Generator] = None,
                             K: int = 5):
        """K categorical samples per node per head from the softmax of the
        logits (reference lta.py:63-71), drawn from ``generator``: returns
        ``([(..., K) int64 per head], logits)``. JAX's keys cannot be
        matched, so the samples agree with the JAX package in distribution
        only. Each sample inverts the softmax's cumulative sum at a uniform
        draw, one a (node, sample) pair, so a ``ShardedGenerator`` gives a
        rank the one-process run's samples of its block."""
        predictions = []
        for head_logits in logits:
            c = head_logits.shape[-1]
            flat = head_logits.reshape(-1, c)
            cdf = torch.softmax(flat.float(), dim=-1).cumsum(-1)
            u = uniform((flat.shape[0], K), generator, flat.device)
            samples = torch.searchsorted(cdf, u, right=True).clamp_max(c - 1)
            predictions.append(samples.reshape(*head_logits.shape[:-1], K))
        return predictions, tuple(logits)


class OSCCTask(ProjectionTask):
    """OSCC: graph-max-pooled binary classification."""

    def __init__(self, name_: str = "oscc", input_size: int = 1024,
                 features_size: int = 1024, dropout: float = 0.0,
                 head_dropout: float = 0.0, loss_func: str = "ce",
                 aux_tasks: Optional[Sequence[str]] = None,
                 average_logits: bool = False, *, device: DeviceLike = None):
        super().__init__(name_, input_size, features_size, dropout,
                         device=device)
        self.loss_func = loss_func
        self.aux_tasks = tuple(aux_tasks or ())
        self.average_logits = average_logits
        self.cls = _Classifier(features_size, 2, head_dropout, device=device)
        for t in self.aux_tasks:
            self.add_module(f"aux_{t}_cls", _Classifier(
                features_size, 2, head_dropout, device=device))

    @staticmethod
    def _pool(features: torch.Tensor,
              node_mask: Optional[torch.Tensor]) -> torch.Tensor:
        # global max pool over nodes (reference oscc.py:68); padded nodes
        # take the dtype's lowest value
        if node_mask is not None:
            neg = torch.finfo(features.dtype).min
            features = torch.where(node_mask[..., None], features, neg)
        return features.amax(dim=-2)

    def forward_logits(self, features: torch.Tensor,
                       node_mask: Optional[torch.Tensor] = None,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       aux_features: AuxFeatures = None) -> torch.Tensor:
        logits = self.cls(self._pool(features, node_mask), train, generator)
        if aux_features is not None:
            aux = [self.forward_aux_logits(f, node_mask, t, train, generator)
                   for t, f in aux_features.items()]
            logits = _fuse(torch.stack([logits, *aux]), self.average_logits)
        return logits

    def forward_aux_logits(self, features: torch.Tensor,
                           node_mask: Optional[torch.Tensor], task: str,
                           train: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        return getattr(self, f"aux_{task}_cls")(
            self._pool(features, node_mask), train, generator)

    def compute_loss(self, logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
        """Phase-2 criterion per sample: CE with label smoothing 0.1
        (oscc.py:90; phase 1 uses the plain CE of the trainer), or BCE /
        focal loss on the one-hot target, averaged over the two classes."""
        if self.loss_func == "ce":
            return cross_entropy(logits, targets, label_smoothing=0.1)
        one_hot = F.one_hot(torch.clamp_min(targets, 0).long(), 2).float()
        if self.loss_func == "bce":
            return bce_with_logits(logits, one_hot).mean(-1)
        if self.loss_func == "focal":
            return sigmoid_focal_loss(logits, one_hot).mean(-1)
        raise ValueError(f"Unknown OSCC loss: {self.loss_func}")


class PNRTask(ProjectionTask):
    """PNR: per-node scalar keyframe logit."""

    def __init__(self, name_: str = "pnr", input_size: int = 1024,
                 features_size: int = 1024, dropout: float = 0.0,
                 head_dropout: float = 0.0,
                 aux_tasks: Optional[Sequence[str]] = None,
                 average_logits: bool = False, *, device: DeviceLike = None):
        super().__init__(name_, input_size, features_size, dropout,
                         device=device)
        self.aux_tasks = tuple(aux_tasks or ())
        self.average_logits = average_logits
        self.cls = _Classifier(features_size, 1, head_dropout, device=device)
        for t in self.aux_tasks:
            self.add_module(f"aux_{t}_cls", _Classifier(
                features_size, 1, head_dropout, device=device))

    def forward_logits(self, features: torch.Tensor,
                       node_mask: Optional[torch.Tensor] = None,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       aux_features: AuxFeatures = None) -> torch.Tensor:
        del node_mask
        logits = self.cls(features, train, generator)  # (B, N, 1)
        if aux_features is not None:
            aux = [self.forward_aux_logits(f, t, train, generator)
                   for t, f in aux_features.items()]
            logits = _fuse(torch.stack([logits, *aux]), self.average_logits)
        return logits[..., 0]  # squeeze (pnr.py:74)

    def forward_aux_logits(self, features: torch.Tensor, task: str,
                           train: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        return getattr(self, f"aux_{task}_cls")(features, train, generator)

    def compute_loss(self, logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
        return bce_with_logits(logits, targets.float())
