"""Temporal pooling: segments to node embedding (counterpart of
``egopack_tpu/models/pooling.py:TRNPooling``).

Flattens the S segment features of each node and runs a 3-layer MLP
(Linear -> LN -> ReLU -> Dropout twice, then a final Linear), as the
reference ``models/temporal_pooling/trn_pooling.py:10-45`` does. The optional
per-frame encodings of the JAX base class (learnt, positional, temporal) are
not ported yet (ROADMAP.md, Queue 1 item 4); the reference experiments never
enable them, and asking for one raises. ``dtype`` goes to ``fc0``, ``fc1``
and ``fc_out`` (``egopack_tpu/models/pooling.py:30``, ``:72``, ``:76``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from ..device import DeviceLike
from .layers import LayerNorm, TLinear, dropout


class TRNPooling(nn.Module):
    """(B, N, S, D) -> (B, N, output_size)."""

    def __init__(self, input_size: int, output_size: int, num_segments: int,
                 hidden_size: int = 1024, dropout: float = 0.0,
                 encoding: Optional[str] = None, *, dtype: Any = None,
                 device: DeviceLike = None):
        super().__init__()
        if encoding is not None:
            raise NotImplementedError(
                f"model.temporal_pooling.encoding={encoding!r} is not ported "
                "yet; see ROADMAP.md, Queue 1 item 4")
        self.input_size = input_size
        self.num_segments = num_segments
        self.dropout = dropout
        self.fc0 = TLinear(num_segments * input_size, hidden_size,
                           dtype=dtype, device=device)
        self.ln0 = LayerNorm(hidden_size, device=device)
        self.fc1 = TLinear(hidden_size, hidden_size, dtype=dtype,
                           device=device)
        self.ln1 = LayerNorm(hidden_size, device=device)
        self.fc_out = TLinear(hidden_size, output_size, dtype=dtype,
                              device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, s, d = x.shape
        if s != self.num_segments or d != self.input_size:
            raise ValueError(
                f"TRNPooling expected (*, {self.num_segments}, "
                f"{self.input_size}), got (*, {s}, {d})")
        h = x.reshape(b, n, s * d)
        for fc, ln in ((self.fc0, self.ln0), (self.fc1, self.ln1)):
            h = torch.relu(ln(fc(h)))
            h = dropout(h, self.dropout, train, generator)
        return self.fc_out(h)
