"""Collectives over one axis of the rank grid, and the autograd functions
that carry them through a backward pass.

An :class:`Axis` is one process group of the mesh: the ranks of a data
column (they hold the same parameter shard and different samples) or of a
model row (the same samples and different shards). Every helper is the
identity on an axis of size 1, so a one-rank axis adds no operation and
changes no number.

The autograd functions follow Megatron-LM's four region operators, plus one
for statistics over the data axis:

- :func:`copy_to` (identity; backward all-reduce): a tensor replicated over
  the model axis enters a sharded product.
- :func:`reduce_from` (all-reduce; backward identity): partial products of
  a sharded product leave into replicated work.
- :func:`gather_from` (all-gather along a dim; backward this rank's slice).
- :func:`scatter_to` (this rank's slice; backward all-gather).
- :func:`sum_over_samples` (all-reduce; backward all-reduce): a sum over the
  data axis whose result feeds every rank's own samples, and so every
  rank's own share of the loss (the graph LayerNorm's statistics over the
  whole batch).

Only ``all_reduce``, ``broadcast`` and ``all_gather`` are called: NCCL and
gloo both run them on CUDA tensors, and gloo on CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One axis of the rank grid: its process group (None when the axis
    has one rank), its size and this rank's index along it."""
    group: Optional[dist.ProcessGroup]
    size: int = 1
    index: int = 0


SINGLE = Axis(None)


def all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``t`` over the axis, in place; returns ``t``."""
    if axis.size > 1:
        dist.all_reduce(t, group=axis.group)
    return t


def all_gather(t: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """Every rank's ``t`` (all of one shape), in axis order."""
    if axis.size == 1:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(out, t, group=axis.group)
    return out


def all_gather_cat(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The axis's ``t`` concatenated along ``dim`` in axis order."""
    if axis.size == 1:
        return t
    return torch.cat(all_gather(t, axis), dim)


def shard_of(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's equal slice of ``t`` along ``dim``."""
    if axis.size == 1:
        return t
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"dim {dim} of size {n} does not split over "
                         f"{axis.size} ranks")
    return t.narrow(dim, axis.index * (n // axis.size), n // axis.size)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverSamples(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return shard_of(g, ctx.axis, ctx.dim).contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return shard_of(x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.axis, ctx.dim), None, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def sum_over_samples(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _SumOverSamples.apply(x, axis)


def gather_from(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    return x if axis.size == 1 else _GatherFrom.apply(x, axis, dim)


def scatter_to(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    return x if axis.size == 1 else _ScatterTo.apply(x, axis, dim)
