"""Fused Adam step with coupled L2 weight decay: the CUDA kernel
``csrc/fused_adam.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``egopack_tpu/ops/pallas/fused_adam.py``
(``fused_adam_leaf``, ``_adam_kernel``, ``_adam_math``). Same function:

    u  = g + wd*p
    m' = b1*m + (1-b1)*u            rounded to the moments dtype
    v' = b2*v + (1-b2)*(u*u)        rounded to the moments dtype
    p' = p + ((m'/bc1) / (sqrt(v'/bc2) + eps)) * (-lr)

The TPU kernel's 128-lane and 16K-element thresholds are TPU layout rules
and are not carried over: every leaf handed to :func:`fused_adam` goes
through the kernel, ragged ones included, in one launch per
``MAX_TENSORS`` leaves (one launch per step for the 61 trainable leaves of
the phase-1 model). The kernel is bound by memory traffic; see the source.

The kernel is built with ``--fmad=false``, so it rounds every operation as
the plain version does and the two agree bit for bit on the card; the checks
allow one unit in the last place of the stored dtype all the same.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from . import cuda_build

MAX_TENSORS = 64  # must match kMaxTensors in csrc/fused_adam.cu
BUILD_FLAGS = ("--fmad=false",)
MOMENT_DTYPES = (torch.float32, torch.bfloat16)

Scalar = Union[float, torch.Tensor]


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """``1 - b**count`` in float32, as the JAX optimizer computes it; a
    Python float64 power differs in the last bits."""
    c = np.float32(count)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** c), float(one - np.float32(b2) ** c))


def fused_adam_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                         v: torch.Tensor, lr: float, bc1: Scalar, bc2: Scalar,
                         *, wd: float, b1: float, b2: float,
                         eps: float) -> None:
    """Plain PyTorch version of the kernel, same operations in the same
    order, updating ``p``, ``m`` and ``v`` in place.

    ``bc1`` and ``bc2`` divide as tensors on ``p``'s device: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal, which rounds
    differently from the kernel's division."""
    bc1 = torch.as_tensor(bc1, dtype=torch.float32, device=p.device)
    bc2 = torch.as_tensor(bc2, dtype=torch.float32, device=p.device)
    u = g + wd * p if wd else g
    m2 = (b1 * m.float() + (1.0 - b1) * u).to(m.dtype)
    v2 = (b2 * v.float() + (1.0 - b2) * (u * u)).to(v.dtype)
    upd = (m2.float() / bc1) / (torch.sqrt(v2.float() / bc2) + eps)
    p.copy_(p + upd * (-lr))
    m.copy_(m2)
    v.copy_(v2)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cuda_build.load("fused_adam", BUILD_FLAGS)
    fn = lib.egopack_fused_adam
    if fn.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_longlong), ptrs, ptrs, ptrs,
                        ptrs] + [ctypes.c_float] * 9 + [ctypes.c_void_p])
        lib.egopack_cuda_error_string.restype = ctypes.c_char_p
        lib.egopack_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(params, grads, exp_avgs, exp_avg_sqs) -> torch.dtype:
    n = len(params)
    if not (len(grads) == len(exp_avgs) == len(exp_avg_sqs) == n):
        raise ValueError("fused_adam: params, grads and moments differ in "
                         "length")
    device = params[0].device
    m_dtype = exp_avgs[0].dtype
    if m_dtype not in MOMENT_DTYPES:
        raise TypeError(f"fused_adam: moments must be float32 or bfloat16, "
                        f"got {m_dtype}")
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        if p.dtype != torch.float32 or g.dtype != torch.float32:
            raise TypeError("fused_adam: params and grads must be float32")
        if m.dtype != m_dtype or v.dtype != m_dtype:
            raise TypeError("fused_adam: all moments must share one dtype")
        for t in (p, g, m, v):
            if t.device != device:
                raise ValueError("fused_adam: tensors on different devices")
            if not t.is_contiguous():
                raise ValueError("fused_adam: tensors must be contiguous")
            if t.numel() != p.numel():
                raise ValueError("fused_adam: shapes of a leaf differ")
    return m_dtype


def fused_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               exp_avgs: Sequence[torch.Tensor],
               exp_avg_sqs: Sequence[torch.Tensor], lr: float, bc1: float,
               bc2: float, *, wd: float, b1: float, b2: float,
               eps: float) -> None:
    """One Adam step over every leaf, in place.

    On CUDA tensors it launches the kernel and adds one to
    ``fused_adam.launches`` per launch; a failed launch raises. Tensors on the
    CPU take :func:`fused_adam_reference`, because no kernel runs there."""
    if not params:
        return
    m_dtype = _check(params, grads, exp_avgs, exp_avg_sqs)
    device = params[0].device
    if device.type == "cpu":
        for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
            fused_adam_reference(p, g, m, v, lr, bc1, bc2, wd=wd, b1=b1,
                                 b2=b2, eps=eps)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_adam: no kernel for device {device}")
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    bf16 = int(m_dtype == torch.bfloat16)
    floats = (lr, bc1, bc2, wd, b1, 1.0 - b1, b2, 1.0 - b2, eps)
    with torch.cuda.device(device):
        for lo in range(0, len(params), MAX_TENSORS):
            group = slice(lo, lo + MAX_TENSORS)
            k = len(params[group])
            numel = (ctypes.c_longlong * k)(*[p.numel() for p in params[group]])
            ptrs = [(ctypes.c_void_p * k)(*[t.data_ptr() for t in ts[group]])
                    for ts in (params, grads, exp_avgs, exp_avg_sqs)]
            err = lib.egopack_fused_adam(bf16, k, numel, *ptrs, *floats,
                                         stream)
            if err != 0:
                msg = lib.egopack_cuda_error_string(err).decode()
                raise RuntimeError(f"fused_adam kernel launch failed: {msg}")
            fused_adam.launches += 1


fused_adam.launches = 0
