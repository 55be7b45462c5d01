"""Sums of squares of many tensors into a few slots: the CUDA kernel
``csrc/sum_squares.cu`` and its plain PyTorch version. The train step's
global and per-layer L2 norms (``optax.global_norm`` in the JAX package,
``egopack_tpu/train/system.py:75-76``) come from one call.

Each tensor (a leaf) names the slots it counts in; slot ``s`` is the sum of
the squares of every element of its leaves, or that sum's square root with
``roots``. A leaf in several slots is read once. The kernel replaces no TPU
kernel: the plain version queues a square, a sum and an add for each leaf,
which XLA fuses on the TPU and the card runs as several hundred small
launches a step. The kernel makes two launches a call and is bound by
memory traffic; see the source.

The kernel sums each chunk of 8192 elements in float32 a thread and
float64 beyond, in a fixed order, so its result is the same on every call
and lies within rounding of a float64 sum; the plain version sums in
float32, leaf by leaf, as the chain it replaces did.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import cuda_build

MAX_LEAVES = 512    # must match kMaxLeaves in csrc/sum_squares.cu
MAX_SLOTS = 256     # must match kMaxSlots
MAX_MEMBERS = 1024  # must match kMaxMembers: leaf-slot pairs a call


def sum_squares_reference(leaves: Sequence[torch.Tensor],
                          slots: Sequence[Sequence[int]], n_slots: int, *,
                          roots: bool) -> torch.Tensor:
    """Plain PyTorch version: each leaf's ``sum(square)``, then each slot's
    leaves added in leaf order from 0, as ``optax.global_norm`` adds them;
    ``(n_slots,)`` float32."""
    sums = [torch.sum(torch.square(t)) for t in leaves]
    out = []
    for s in range(n_slots):
        total = sum((x for x, named in zip(sums, slots) if s in named),
                    torch.zeros((), device=leaves[0].device))
        out.append(total)
    out = torch.stack(out)
    return torch.sqrt(out) if roots else out


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cuda_build.load("sum_squares")
    fn = lib.egopack_sum_squares
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = i32
        fn.argtypes = [i32, ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_void_p), i32,
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_ushort), i32, ptr, ptr, ptr]
        chunks = lib.egopack_sum_squares_chunks
        chunks.restype = ctypes.c_longlong
        chunks.argtypes = [i32, ctypes.POINTER(ctypes.c_longlong)]
        lib.egopack_sum_squares_error_string.restype = ctypes.c_char_p
        lib.egopack_sum_squares_error_string.argtypes = [i32]
    return lib


def _check(leaves: Sequence[torch.Tensor], slots: Sequence[Sequence[int]],
           n_slots: int) -> None:
    if not leaves or len(slots) != len(leaves):
        raise ValueError("sum_squares: one slot list a leaf, and a leaf at "
                         "least")
    if not 1 <= n_slots <= MAX_SLOTS:
        raise ValueError(f"sum_squares: 1 to {MAX_SLOTS} slots, got "
                         f"{n_slots}")
    device = leaves[0].device
    for t, named in zip(leaves, slots):
        if t.dtype != torch.float32:
            raise TypeError(f"sum_squares: leaves must be float32, got "
                            f"{t.dtype}")
        if t.device != device:
            raise ValueError("sum_squares: leaves on different devices")
        if not t.is_contiguous():
            raise ValueError("sum_squares: leaves must be contiguous")
        if any(not 0 <= s < n_slots for s in named):
            raise ValueError(f"sum_squares: slot out of range 0..{n_slots - 1}"
                             f" in {list(named)}")


def sum_squares(leaves: Sequence[torch.Tensor],
                slots: Sequence[Sequence[int]], n_slots: int, *,
                roots: bool) -> torch.Tensor:
    """For each slot ``s < n_slots``, the sum of the squares of the elements
    of every leaf whose entry of ``slots`` names ``s`` (0 for a slot that no
    leaf names), or its square root with ``roots``: ``(n_slots,)`` float32
    on the leaves' device.

    On CUDA tensors it launches the kernel and adds one to
    ``sum_squares.launches`` per launch (two a call); a failed launch
    raises. Tensors on the CPU take :func:`sum_squares_reference`, because
    no kernel runs there."""
    _check(leaves, slots, n_slots)
    device = leaves[0].device
    if device.type == "cpu":
        return sum_squares_reference(leaves, slots, n_slots, roots=roots)
    if device.type != "cuda":
        raise ValueError(f"sum_squares: no kernel for device {device}")
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"sum_squares: at most {MAX_LEAVES} leaves a call, "
                         f"got {len(leaves)}")
    members = [[i for i, named in enumerate(slots) if s in named]
               for s in range(n_slots)]
    starts = [0]
    for m in members:
        starts.append(starts[-1] + len(m))
    if starts[-1] > MAX_MEMBERS:
        raise ValueError(f"sum_squares: at most {MAX_MEMBERS} leaf-slot "
                         f"pairs a call, got {starts[-1]}")
    lib = load_library()
    k = len(leaves)
    numel = (ctypes.c_longlong * k)(*[t.numel() for t in leaves])
    ptrs = (ctypes.c_void_p * k)(*[t.data_ptr() for t in leaves])
    start = (ctypes.c_int * (n_slots + 1))(*starts)
    flat = [i for m in members for i in m]
    member = (ctypes.c_ushort * max(len(flat), 1))(*flat)
    chunks = lib.egopack_sum_squares_chunks(k, numel)
    partials = torch.empty(max(chunks, 1), dtype=torch.float64, device=device)
    out = torch.empty(n_slots, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.egopack_sum_squares(k, numel, ptrs, n_slots, start, member,
                                      int(roots), partials.data_ptr(),
                                      out.data_ptr(), stream)
    if err != 0:
        msg = lib.egopack_sum_squares_error_string(err).decode()
        raise RuntimeError(f"sum_squares kernel launch failed: {msg}")
    sum_squares.launches += 2 if chunks else 1  # no first pass over nothing
    return out


sum_squares.launches = 0
