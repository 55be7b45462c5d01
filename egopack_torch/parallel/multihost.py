"""Processes, their loader shards and the meters' exchange (the port's
counterpart of ``egopack_tpu/parallel/multihost.py``).

``torchrun`` starts one process per GPU; :func:`initialize` joins them
into one ``torch.distributed`` world. Each rank's loaders build only its
data index's block of every global batch (``data/loader.py``,
``process_shard``), so the loaders' ``DeviceCopier.put`` moves that block
to the rank's device as it is (JAX's ``global_batch``/``put_batch``), and
a rank's outputs are its block's rows (JAX's ``local_block``). Validation
is sharded the same way: each rank meters its block, the per-batch loss is
reduced over the data axis, and the meters' states are exchanged at the
end of the pass (:func:`merge_meter`) as npz payloads of plain numeric
arrays, never pickles (``multihost.py:123-165``).

The backend is NCCL for CUDA devices and gloo for the CPU, unless
``EGOPACK_DIST_BACKEND`` names one. A backend that fails to start raises:
nothing falls back to another backend or to the CPU.
"""

from __future__ import annotations

import io
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import Axis, all_gather
from .mesh import Mesh

logger = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")


def rank_device(device: torch.device) -> torch.device:
    """This process's device: a CUDA device without an index becomes
    ``cuda:<LOCAL_RANK mod device count>`` (so two ranks share one card
    when there is one)."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(device: torch.device) -> str:
    """``EGOPACK_DIST_BACKEND`` if set, else NCCL for CUDA devices and gloo
    for the CPU. NCCL on the CPU is refused."""
    name = os.environ.get("EGOPACK_DIST_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if name not in BACKENDS:
        raise ValueError(f"EGOPACK_DIST_BACKEND={name!r}: expected one of "
                         f"{BACKENDS}")
    if name == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices; the device is "
                         f"{device}")
    return name


def initialize(device: torch.device, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> torch.device:
    """Join the ``torch.distributed`` world, once per process (later calls
    return at once); returns this rank's device (:func:`rank_device`).
    Without arguments the rendezvous is ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as ``torchrun`` sets them).
    NCCL starts eagerly on the rank's device, so a communicator it refuses
    raises here. Failures are not caught (``multihost.py:40-58``)."""
    device = rank_device(device)
    if dist.is_initialized():
        return device
    backend = backend_for(device)
    kw: Dict[str, Any] = {"init_method": init_method or "env://"}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(backend, **kw)
    logger.info("torch.distributed: rank %d of %d, backend %s, device %s",
                dist.get_rank(), dist.get_world_size(), backend, device)
    return device


def process_shard(mesh: Mesh) -> Optional[Tuple[int, int]]:
    """``(data index, data size)`` for the loaders; None on one data row."""
    if mesh.data == 1:
        return None
    return (mesh.data_index, mesh.data)


def allgather_bytes(payload: bytes, axis: Axis,
                    device: torch.device) -> List[bytes]:
    """Every rank's payload over ``axis``, in axis order: the lengths
    first, then the payloads padded to the longest, as uint8 tensors on
    ``device`` (NCCL moves CUDA tensors only)."""
    if axis.size == 1:
        return [payload]
    data = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    n = torch.tensor([data.numel()], dtype=torch.int64, device=device)
    lens = [int(x) for x in all_gather(n, axis)]
    padded = torch.zeros(max(lens), dtype=torch.uint8, device=device)
    padded[:data.numel()] = data.to(device)
    return [bytes(t[:m].cpu().numpy())
            for t, m in zip(all_gather(padded, axis), lens)]


def state_to_bytes(pid: int, st: Dict) -> bytes:
    """One meter ``state()`` as an npz blob: scalars and lists of numeric
    arrays, nothing else (``multihost.py:123-145``)."""
    arrays: Dict[str, np.ndarray] = {"__pid__": np.asarray(pid, np.int64)}
    for key, val in st.items():
        if isinstance(val, list):
            arrays[f"__len__/{key}"] = np.asarray(len(val), np.int64)
            for i, item in enumerate(val):
                arrays[f"L/{key}/{i}"] = np.asarray(item)
        else:
            arrays[f"S/{key}"] = np.asarray(val)
    for key, arr in arrays.items():
        if arr.dtype == object:
            raise TypeError(f"meter state entry {key!r} is not numeric")
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def state_from_bytes(blob: bytes) -> Tuple[int, Dict]:
    """Inverse of :func:`state_to_bytes`; numpy's ``allow_pickle=False``
    default keeps a peer's payload from running code here."""
    def value(a):
        return a.item() if a.ndim == 0 else a

    with np.load(io.BytesIO(blob)) as z:
        pid = int(z["__pid__"])
        st: Dict[str, Any] = {}
        for key in z.files:
            if key.startswith("S/"):
                st[key[2:]] = value(z[key])
        for key in z.files:
            if key.startswith("__len__/"):
                name = key.split("/", 1)[1]
                st[name] = [value(z[f"L/{name}/{i}"])
                            for i in range(int(z[key]))]
    return pid, st


def merge_meter(meter, mesh: Mesh) -> None:
    """Give ``meter`` the accumulators of the whole data axis, in the order
    one process over the global batches would have made them
    (``BaseMeter.merge_states``). The loss accumulators stay: every rank
    recorded the same global per-batch losses. The ranks of a model row
    meter the same samples, so states travel over the data axis only."""
    if mesh.data == 1:
        return
    blobs = allgather_bytes(state_to_bytes(mesh.data_index, meter.state()),
                            mesh.data_axis, mesh.device)
    states = dict(state_from_bytes(b) for b in blobs)
    meter.merge_states([states[i] for i in range(mesh.data)])
