"""The ``(data, model)`` grid of ranks and what lives on it (the port's
counterpart of ``egopack_tpu/parallel/mesh.py``).

One process drives one GPU. Rank ``r`` sits at ``(r // model, r % model)``
of the grid. The ranks of a data column hold the same parameter shards and
different samples: gradients are summed over them. The ranks of a model row
hold the same samples and different shards: the TRN pooling MLP is split
over them Megatron-style (``fc0`` by output columns, ``fc1`` by input rows,
``egopack_tpu/parallel/mesh.py:69-83``), and so are the prototype banks, by
row (``:101-124``), and with ``graphone.freeze=False`` the trained bank
values with them. Every other parameter is replicated.

Unlike the JAX mesh, which warns and leaves devices idle
(``mesh.py:37-43``), the grid must hold every rank: an idle process would
wait at the first collective forever, so :func:`make_mesh` raises.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

from .collectives import SINGLE, Axis, all_gather_cat, shard_of

logger = logging.getLogger(__name__)


@dataclass
class Mesh:
    """The grid, this rank's place in it, and the two axes it reduces
    over: ``data_axis`` (its data column) and ``model_axis`` (its model
    row)."""
    data: int = 1
    model: int = 1
    rank: int = 0
    data_axis: Axis = SINGLE
    model_axis: Axis = SINGLE
    device: torch.device = field(
        default_factory=lambda: torch.device("cpu"))

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(data: int = -1, model: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """The grid over every process of the initialized world (one process
    without ``torch.distributed``). ``data=-1`` means ``world // model``.
    ``data * model`` must equal the world size. With ``torch.distributed``
    up, every rank makes every group, in one order, as
    ``dist.new_group`` asks."""
    dev = torch.device(device if device is not None else "cpu")
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    if model < 1:
        raise ValueError(f"parallel.model={model} must be at least 1")
    if data == -1:
        data = world // model
    if data < 1 or data * model != world:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} processes, the world "
            f"has {world}: parallel.data x parallel.model must equal the "
            "number of processes (an idle process would hang at the first "
            "collective)")
    mesh = Mesh(data, model, rank, device=dev)
    if not up:
        return mesh
    for c in range(model):  # data columns
        ranks = [d * model + c for d in range(data)]
        group = dist.new_group(ranks)
        if rank in ranks:
            mesh.data_axis = Axis(group, data, rank // model)
    for d in range(data):  # model rows
        ranks = [d * model + c for c in range(model)]
        group = dist.new_group(ranks)
        if rank in ranks:
            mesh.model_axis = Axis(group, model, rank % model)
    logger.info("mesh %dx%d (data x model): rank %d at (%d, %d) on %s",
                data, model, rank, mesh.data_index, mesh.model_index, dev)
    return mesh


def check_batch_divisible(batch_size: int, mesh: Mesh) -> None:
    """Fail fast, legibly, when the global batch cannot split over the data
    axis (``egopack_tpu/parallel/mesh.py:48-56``)."""
    if batch_size % mesh.data:
        raise SystemExit(
            f"Invalid configuration: batch_size={batch_size} is not "
            f"divisible by parallel.data={mesh.data}. Aborting!")


def param_spec(name: str, shape, model: int) -> Optional[int]:
    """The dimension of parameter ``name`` (torch layout) split over the
    model axis, or None when it is replicated: the TRN pooling's ``fc0``
    weight and bias by output column, its ``fc1`` weight by input row, each
    only where the width divides (``egopack_tpu/parallel/mesh.py:69-83``;
    torch's ``(out, in)`` weight is the flax kernel transposed), and the
    trained bank values by row."""
    if model == 1:
        return None
    if name in ("temporal_graph.pooling.fc0.weight",
                "temporal_graph.pooling.fc0.bias"):
        return 0 if shape[0] % model == 0 else None
    if name == "temporal_graph.pooling.fc1.weight":
        return 1 if shape[1] % model == 0 else None
    if name.startswith("graphone_banks."):
        return 0 if shape[0] % model == 0 else None
    return None


def param_shardings(params: Dict[str, torch.Tensor],
                    mesh: Mesh) -> Dict[str, Optional[int]]:
    """``param_spec`` of every parameter, at its full shape."""
    return {n: param_spec(n, tuple(p.shape), mesh.model)
            for n, p in params.items()}


def place_params(system, mesh: Mesh) -> None:
    """Keep this rank's slice of every split parameter of ``system`` (full
    shape on entry; parameters split earlier are left as they are) and
    wire the system's modules to the mesh. Call before the optimizer's
    ``init``, whose moments take the parameters' shapes."""
    params = system.params()
    with torch.no_grad():
        for name, dim in param_shardings(params, mesh).items():
            p = params[name]
            if dim is not None and name not in system.shards:
                p.data = shard_of(p.data, mesh.model_axis, dim).clone()
                system.shards[name] = dim
    system.use_mesh(mesh)


def gather_params(params: Dict[str, torch.Tensor], shards: Dict[str, int],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Full tensors of ``params``: split ones gathered over the model axis
    (a collective: every rank calls it), the others as they are."""
    return {n: (all_gather_cat(p.detach(), mesh.model_axis, shards[n])
                if n in shards else p)
            for n, p in params.items()}


def place_banks(banks, mesh: Mesh):
    """This rank's rows of every prototype bank, values and mask alike
    (``egopack_tpu/parallel/mesh.py:101-124``); the banks as they are when
    ``model`` is 1. Banks are padded to a multiple of 128 rows, so any
    model axis up to 128 that divides 128 splits them evenly."""
    from ..models.graphone import PrototypeBank
    if mesh.model == 1:
        return banks
    out = {}
    for t, b in banks.items():
        out[t] = PrototypeBank(
            shard_of(b.values, mesh.model_axis, 0).clone(),
            shard_of(b.mask, mesh.model_axis, 0).clone())
    return out


def gather_banks(banks, mesh: Mesh):
    """Whole banks from every rank's rows (a collective)."""
    from ..models.graphone import PrototypeBank
    if mesh.model == 1:
        return banks
    return {t: PrototypeBank(all_gather_cat(b.values, mesh.model_axis, 0),
                             all_gather_cat(b.mask, mesh.model_axis, 0))
            for t, b in banks.items()}


def replicate(tensors: Iterable[torch.Tensor]) -> None:
    """Broadcast ``tensors`` from rank 0 to every rank, in place, one
    broadcast per dtype (a no-op without ``torch.distributed``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=0)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
