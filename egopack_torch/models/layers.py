"""Core layers (counterpart of ``egopack_tpu/models/layers.py``): torch-init
Linear with the bf16-input/f32-output policy, per-feature LayerNorm, graph-mode
LayerNorm, dense SAGE convolution, sinusoidal positional encoding, and the
dropout every module draws from an explicit generator.

Parameters are created as zeros (LayerNorm scales as ones) on the given
device; ``reset_parameters(generator)`` draws the torch-default init. No
module touches the global RNG.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops import gemm
from ..parallel.collectives import (SINGLE, Axis, all_reduce_, reduce_from,
                                    sum_over_samples)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(value: Any) -> Optional[torch.dtype]:
    """A layer's ``dtype`` as the JAX configs give it: ``None``, the name
    ``"float32"`` or ``"bfloat16"`` (``+model.propagate_dtype=bfloat16``),
    or a ``torch.dtype`` of the two."""
    if value is None or value in DTYPES.values():
        return value
    if isinstance(value, str) and value in DTYPES:
        return DTYPES[value]
    raise ValueError(f"dtype must be None, float32 or bfloat16, got {value!r}")


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices, summed and returned in float32. On
    the card one cuBLAS bf16 GEMM on the tensor cores (``aten::mm.dtype``);
    on the CPU, which has no such overload, the float32 product of the same
    values, which is exact in each term."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _Bf16Linear(torch.autograd.Function):
    """``x @ wᵀ`` for bf16 ``x (..., in)`` and ``w (out, in)``, float32 out:
    ``jnp.dot(x, k, preferred_element_type=float32)`` of the JAX layer.

    The gradients follow JAX's transpose rule: each is a float32 product
    rounded to its operand's dtype, bf16. When the incoming gradient holds
    bf16 values (``grad_is_bf16``: the layer rounds its output to bf16, so
    its cotangent is bf16), those products are bf16 GEMMs too; otherwise
    they run in float32, as on the CPU."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor,
                grad_is_bf16: bool) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.grad_is_bf16 = grad_is_bf16
        y = _mm_f32(x.reshape(-1, x.shape[-1]), w.t())
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.grad_is_bf16:
            g2 = g2.to(torch.bfloat16)
            mm = _mm_f32
        else:
            def mm(a, b):
                return torch.mm(a.float(), b.float())
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = mm(g2, w).to(torch.bfloat16).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = mm(g2.t(), x.reshape(-1, x.shape[-1])).to(torch.bfloat16)
        return gx, gw, None


class ShardedGenerator:
    """A generator for one rank's block of a batch split over the data
    axis: each random tensor is drawn at the global batch's shape and this
    rank's block is kept, so the masks are the one-process run's. The
    block is ``index`` of ``count`` equal blocks of axis 0, or with
    ``rows`` the given rows of axis 1 of ``total`` (the multi-task step's
    concatenated node sets)."""

    def __init__(self, generator: torch.Generator, index: int, count: int,
                 rows: Optional[torch.Tensor] = None, total: int = 0):
        self.generator = generator
        self.index, self.count = index, count
        self.rows, self.total = rows, total

    def with_rows(self, rows: torch.Tensor, total: int) -> "ShardedGenerator":
        return ShardedGenerator(self.generator, self.index, self.count, rows,
                                total)

    def rand(self, shape, device) -> torch.Tensor:
        if self.rows is None:
            full = torch.rand((self.count * shape[0],) + tuple(shape[1:]),
                              generator=self.generator, device=device)
            return full[self.index * shape[0]:(self.index + 1) * shape[0]]
        if shape[1] != self.rows.numel():
            raise ValueError(f"{self.rows.numel()} rows for a tensor of "
                             f"shape {tuple(shape)}")
        full = torch.rand((shape[0], self.total) + tuple(shape[2:]),
                          generator=self.generator, device=device)
        return full.index_select(1, self.rows)


def uniform(shape, generator, device) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` from a ``torch.Generator`` or a
    :class:`ShardedGenerator`."""
    if isinstance(generator, ShardedGenerator):
        return generator.rand(shape, device)
    return torch.rand(shape, generator=generator, device=device)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout`` semantics: kept entries are
    scaled by ``1/keep``). The mask comes from ``generator``, which must
    live on ``x``'s device, or a :class:`ShardedGenerator` over one."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    u = uniform(x.shape, generator, x.device)
    return torch.where(u < keep_prob, x / keep_prob, 0.0)


class TLinear(nn.Module):
    """Linear layer with torch-default init, ``weight (out, in)``
    (``egopack_tpu/models/layers.py:29-59``).

    Mixed-precision policy of the JAX layer: the product's operands take
    ``dtype`` if it is given, else the input's dtype. bf16 operands (input
    and rounded weight) are summed in float32 and the result, bias added, is
    float32 with ``dtype=None`` and rounded to bf16 with
    ``dtype=bfloat16``. On the card that product is a bf16 tensor-core GEMM
    with float32 output; on the CPU it is the float32 product of the
    rounded operands, which is the same number up to the order of the sums
    (a product of two bf16 values is exact in float32). A bf16-output GEMM
    would round before the bias is added, where JAX rounds after, so it is
    not used."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, dtype: Any = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = resolve_dtype(dtype)
        self.weight = nn.Parameter(torch.zeros(out_features, in_features,
                                               device=dev))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=dev))
        else:
            self.register_parameter("bias", None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in)), bias likewise
        bound = 1.0 / math.sqrt(self.in_features)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor,
                reduce_axis: Axis = SINGLE) -> torch.Tensor:
        """``reduce_axis``: the weight holds this rank's input rows of a
        row-parallel product; the partial products are summed over the
        axis, in float32, before the bias and the rounding to ``dtype``."""
        in_dtype = self.dtype or x.dtype
        if in_dtype != torch.bfloat16:
            if reduce_axis.size == 1:
                return gemm.linear(x.to(in_dtype), self.weight, self.bias)
            y = reduce_from(gemm.linear(x.to(in_dtype), self.weight),
                            reduce_axis)
            return y if self.bias is None else y + self.bias
        y = _Bf16Linear.apply(x.to(torch.bfloat16),
                              self.weight.to(torch.bfloat16),
                              self.dtype == torch.bfloat16)
        y = reduce_from(y, reduce_axis)
        if self.bias is not None:
            y = y + self.bias
        return y if self.dtype is None else y.to(self.dtype)


class LayerNorm(nn.Module):
    """Per-feature LayerNorm with torch defaults (eps=1e-5 inside the rsqrt,
    affine), computed in float32 and returned in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, *,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=dev))
        self.bias = nn.Parameter(torch.zeros(dim, device=dev))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


class GraphLayerNorm(LayerNorm):
    """PyG ``LayerNorm(mode='graph')`` called without a batch vector.

    The reference normalises over the ENTIRE batched node tensor:
    ``(x - mean) / (std(unbiased=False) + eps)``, eps added to the std, not
    the variance, then a per-feature affine. Masked so padded nodes do not
    enter the statistics. It is not ``F.layer_norm``.

    With the batch split over the data axis (``data_axis``), the statistics
    are those of the global batch: the masked sums and counts are summed
    over the axis (``sum_over_samples``), as GSPMD does for the JAX mesh."""

    data_axis: Axis = SINGLE

    def forward(self, x: torch.Tensor, node_mask: Optional[torch.Tensor] = None,
                task_onehot: Optional[torch.Tensor] = None) -> torch.Tensor:
        """With ``task_onehot (T, M)`` the input is the concatenated layout
        ``x (1, M, H)`` of several tasks' node sets; each task gets its own
        whole-tensor masked statistics through two small ``(T, M)``
        products."""
        x32 = x.float()
        if node_mask is None and self.data_axis.size == 1:
            mean = x32.mean()
            var = ((x32 - mean) ** 2).mean()
        else:
            mean, var = self._moments(x32, node_mask, task_onehot)
        y = (x32 - mean) / (torch.sqrt(var) + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)

    def _moments(self, x32: torch.Tensor, node_mask: Optional[torch.Tensor],
                 task_onehot: Optional[torch.Tensor]):
        """Masked mean and variance over the global batch: each sum is this
        rank's masked sum, summed over the data axis with its count (the
        identity on a one-rank axis)."""
        axis, dim = self.data_axis, x32.shape[-1]
        if task_onehot is not None:
            m = node_mask.float()                                  # (M,)
            cnt = torch.clamp_min(all_reduce_(task_onehot @ m * dim, axis),
                                  1.0)                             # (T,)
            row_sum = (x32[0] * m[:, None]).sum(-1)
            mean_t = sum_over_samples(task_onehot @ row_sum, axis) / cnt
            mean = (task_onehot.t() @ mean_t)[None, :, None]
            row_var = (((x32 - mean) ** 2)[0] * m[:, None]).sum(-1)
            var_t = sum_over_samples(task_onehot @ row_var, axis) / cnt
            return mean, (task_onehot.t() @ var_t)[None, :, None]
        m = (torch.ones_like(x32[..., :1]) if node_mask is None
             else node_mask.float()[..., None])
        count = torch.clamp_min(all_reduce_(m.sum() * dim, axis), 1.0)
        mean = sum_over_samples((x32 * m).sum(), axis) / count
        var = sum_over_samples((((x32 - mean) ** 2) * m).sum(), axis) / count
        return mean, var


class DenseSAGEConv(nn.Module):
    """GraphSAGE convolution over a dense in-neighbour mask, mean
    aggregation (PyG ``SAGEConv`` math):

    - ``project``: messages are ``relu(W_p x_j + b_p)`` instead of ``x_j``
    - mean over in-neighbours ``j`` with ``adj[t, j]``; a node with no
      in-neighbours aggregates to 0 (PyG scatter semantics)
    - output ``W_l agg (+ b_l) + W_r x_t``; the root weight has no bias

    ``dtype`` goes to the three linears (``egopack_tpu/models/layers.py:
    147-160``): ``bfloat16`` keeps the activations in bf16 between layers.
    """

    def __init__(self, in_features: int, out_features: int,
                 project: bool = False, bias: bool = True, *,
                 dtype: Any = None, device: DeviceLike = None):
        super().__init__()
        msg_features = out_features if project else in_features
        if project:
            self.lin_project = TLinear(in_features, out_features,
                                       dtype=dtype, device=device)
        self.project = project
        self.lin_l = TLinear(msg_features, out_features, bias=bias,
                             dtype=dtype, device=device)
        self.lin_r = TLinear(in_features, out_features, bias=False,
                             dtype=dtype, device=device)

    def _messages(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.lin_project(x)) if self.project else x

    @staticmethod
    def _aggregate(msg: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """Mean over in-neighbours in JAX's order of casts
        (``egopack_tpu/models/layers.py:165-170``): the sum in float32, cast
        to the messages' dtype, then divided by a degree in that dtype, so
        under bf16 propagation the division is a bf16 one.
        adj (N, N) broadcasts over the batch; (B, N, N) is per sample."""
        a = adj.to(msg.dtype)
        deg = torch.clamp_min(a.sum(-1, keepdim=True), 1.0)
        agg = torch.matmul(a.float(), msg.float()).to(msg.dtype) / deg
        return torch.where(adj.any(-1, keepdim=True), agg, 0.0)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x (B, N, H); adj (B, N, N) or (N, N) bool in-neighbour mask."""
        agg = self._aggregate(self._messages(x), adj)
        return self.lin_l(agg) + self.lin_r(x)

    def concat(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """Concatenated layout: ``x (1, M, H)`` stacks every task's node set;
        ``adj (M, M)`` is the block-diagonal in-neighbour mask over it, so the
        aggregation is one (M, M) x (M, H) product."""
        agg = self._aggregate(self._messages(x)[0], adj)[None]
        return self.lin_l(agg) + self.lin_r(x)

    def multi(self, xs: Sequence[torch.Tensor],
              adjs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Several graphs at once: the per-node products run once over the
        concatenation of every graph's nodes; only the aggregation stays per
        graph. Same numbers as calling ``forward`` per graph."""
        sizes = [(x.shape[0], x.shape[1]) for x in xs]
        flat = torch.cat([x.reshape(1, -1, x.shape[-1]) for x in xs], 1)
        msg_flat = self._messages(flat)
        aggs, off = [], 0
        for (b, n), adj in zip(sizes, adjs):
            msg = msg_flat[0, off:off + b * n].reshape(b, n, -1)
            off += b * n
            aggs.append(self._aggregate(msg, adj).reshape(1, b * n, -1))
        out_flat = self.lin_l(torch.cat(aggs, 1)) + self.lin_r(flat)
        outs, off = [], 0
        for b, n in sizes:
            outs.append(out_flat[0, off:off + b * n].reshape(b, n, -1))
            off += b * n
        return outs


def positional_encoding(pos: torch.Tensor, out_channels: int,
                        base_freq: float = 1e-4) -> torch.Tensor:
    """PyG ``PositionalEncoding``: frequencies ``base_freq ** linspace(0, 1,
    C/2)`` in float32; output ``[sin(pos*f), cos(pos*f)]`` on the channel
    axis."""
    half = out_channels // 2
    if half > 1:
        exponents = torch.linspace(0.0, 1.0, half, device=pos.device)
    else:
        exponents = torch.zeros(max(half, 1), device=pos.device)
    # a fill on the device: a copy from the host cannot be captured into a
    # CUDA graph
    freqs = torch.pow(torch.full((), base_freq, dtype=torch.float32,
                                 device=pos.device), exponents)
    angles = pos.float()[..., None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
