"""Per-task projection heads: AR, LTA, OSCC, PNR (counterpart of
``egopack_tpu/models/heads.py``, phase-1 part).

- shared projection MLP Dropout -> Linear -> LN -> ReLU -> Linear
  (reference ``models/tasks/task.py:17-23``)
- AR/LTA: one (Dropout -> Linear) classifier per label head
- OSCC: masked global max pool over nodes, then a 2-way classifier
- PNR: per-node scalar logit, squeezed

Submodule names follow the flax tree (``proj_fc0``, ``proj_ln``,
``proj_fc1``, ``cls{i}/TLinear_0``, ``cls/TLinear_0``). The auxiliary
classifiers, late fusion, ``compute_loss`` and
``LTATask.generate_from_logits`` belong to phase 2 and are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..device import DeviceLike
from .layers import LayerNorm, TLinear, dropout


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


class RecognitionTask(ProjectionTask):
    """AR: multi-head (verb, noun) classification."""

    def __init__(self, name_: str = "ar", input_size: int = 1024,
                 features_size: int = 1024, dropout: float = 0.0,
                 heads: Sequence[int] = (1, 1), head_dropout: float = 0.0, *,
                 device: DeviceLike = None):
        super().__init__(name_, input_size, features_size, dropout,
                         device=device)
        self.num_heads = len(heads)
        for i, h in enumerate(heads):
            self.add_module(f"cls{i}", _Classifier(features_size, h,
                                                   head_dropout, device=device))

    def forward_logits(self, features: torch.Tensor,
                       node_mask: Optional[torch.Tensor] = None,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, ...]:
        del node_mask
        return tuple(getattr(self, f"cls{i}")(features, train, generator)
                     for i in range(self.num_heads))


class LTATask(RecognitionTask):
    """LTA: per-node (verb, noun) heads."""


class OSCCTask(ProjectionTask):
    """OSCC: graph-max-pooled binary classification."""

    def __init__(self, name_: str = "oscc", input_size: int = 1024,
                 features_size: int = 1024, dropout: float = 0.0,
                 head_dropout: float = 0.0, *, device: DeviceLike = None):
        super().__init__(name_, input_size, features_size, dropout,
                         device=device)
        self.cls = _Classifier(features_size, 2, head_dropout, device=device)

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
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        return self.cls(self._pool(features, node_mask), train, generator)


class PNRTask(ProjectionTask):
    """PNR: per-node scalar keyframe logit."""

    def __init__(self, name_: str = "pnr", input_size: int = 1024,
                 features_size: int = 1024, dropout: float = 0.0,
                 head_dropout: float = 0.0, *, device: DeviceLike = None):
        super().__init__(name_, input_size, features_size, dropout,
                         device=device)
        self.cls = _Classifier(features_size, 1, head_dropout, device=device)

    def forward_logits(self, features: torch.Tensor,
                       node_mask: Optional[torch.Tensor] = None,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        del node_mask
        return self.cls(features, train, generator)[..., 0]
