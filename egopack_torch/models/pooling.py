"""Temporal pooling: segments to node embedding (counterpart of
``egopack_tpu/models/pooling.py:TRNPooling``).

Flattens the S segment features of each node and runs a 3-layer MLP
(Linear -> LN -> ReLU -> Dropout twice, then a final Linear), as the
reference ``models/temporal_pooling/trn_pooling.py:10-45`` does. The
optional per-frame encoding of the JAX base class
(``egopack_tpu/models/pooling.py:27-53``; reference pooling.py:50-90) is
added to every node's segments first: a ``TLinear`` named ``encoding_mlp``
over a learnt table ``frame_encoding`` (S, D) (``learnt``), over the
sinusoidal positional encoding of the segment index (``positional``), or
over the functional time encoding ``cos(t * w)``, ``w_i = 1/10000^(i/D)``
(``temporal``). The reference experiments never enable one. ``dtype`` goes
to ``fc0``, ``fc1`` and ``fc_out`` (``egopack_tpu/models/pooling.py:30``,
``:72``, ``:76``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from ..device import DeviceLike
from .layers import LayerNorm, TLinear, dropout, positional_encoding

ENCODINGS = ("learnt", "positional", "temporal")


class TRNPooling(nn.Module):
    """(B, N, S, D) -> (B, N, output_size)."""

    def __init__(self, input_size: int, output_size: int, num_segments: int,
                 hidden_size: int = 1024, dropout: float = 0.0,
                 encoding: Optional[str] = None, *, dtype: Any = None,
                 device: DeviceLike = None):
        super().__init__()
        if encoding is not None and encoding not in ENCODINGS:
            raise ValueError(f"Unsupported encoding: {encoding}")
        self.input_size = input_size
        self.num_segments = num_segments
        self.dropout = dropout
        self.encoding = encoding
        if encoding == "learnt":
            self.frame_encoding = nn.Parameter(torch.zeros(
                num_segments, input_size, device=device))
        if encoding is not None:
            self.encoding_mlp = TLinear(input_size, input_size, device=device)
        self.fc0 = TLinear(num_segments * input_size, hidden_size,
                           dtype=dtype, device=device)
        self.ln0 = LayerNorm(hidden_size, device=device)
        self.fc1 = TLinear(hidden_size, hidden_size, dtype=dtype,
                           device=device)
        self.ln1 = LayerNorm(hidden_size, device=device)
        self.fc_out = TLinear(hidden_size, output_size, dtype=dtype,
                              device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The learnt table's init, U[0, 1) (flax ``uniform(1.0)``); the
        layers reset themselves."""
        if self.encoding == "learnt":
            self.frame_encoding.uniform_(0.0, 1.0, generator=generator)

    def encoding_table(self) -> torch.Tensor:
        """The (S, D) input of ``encoding_mlp``."""
        if self.encoding == "learnt":
            return self.frame_encoding
        dev = self.encoding_mlp.weight.device
        t = torch.arange(self.num_segments, dtype=torch.float32, device=dev)
        if self.encoding == "positional":
            return positional_encoding(t, self.input_size)
        i = torch.arange(self.input_size, dtype=torch.float32, device=dev)
        w = 1.0 / torch.pow(10000.0, i / self.input_size)
        return torch.cos(t[:, None] * w[None, :])

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, s, d = x.shape
        if s != self.num_segments or d != self.input_size:
            raise ValueError(
                f"TRNPooling expected (*, {self.num_segments}, "
                f"{self.input_size}), got (*, {s}, {d})")
        if self.encoding is not None:
            x = x + self.encoding_mlp(self.encoding_table())
        h = x.reshape(b, n, s * d)
        for fc, ln in ((self.fc0, self.ln0), (self.fc1, self.ln1)):
            h = torch.relu(ln(fc(h)))
            h = dropout(h, self.dropout, train, generator)
        return self.fc_out(h)
