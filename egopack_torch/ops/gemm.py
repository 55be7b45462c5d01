"""Float32 matrix products on the tensor cores at float32 accuracy: the
CUDA kernel ``csrc/tf32x3_gemm.cu`` (split TF32, three tensor-core
products a float32 product), its plain PyTorch version, and the autograd
functions that the linear layers (``models/layers.py:TLinear``) and
GraphONE's stages (``models/graphone.py:GraphONE.interact``) run.

``tf32x3_gemm(a, b, layout)`` takes three layouts, each 2-D or batched 3-D
with the batch first: ``"nt"`` ``a @ bᵀ`` (a linear layer's ``x @ Wᵀ``),
``"nn"`` ``a @ b`` (``g @ W``, GraphONE's ``x @ W``) and ``"tn"`` ``aᵀ @
b`` (a weight's gradient ``gᵀ @ x``). The tiling (rows a block, columns a
block, splits over K) comes from the shape alone (:func:`plan`). A product
split over K adds its splits in a fixed order, so two calls on the same
inputs give the same bits, and a CUDA graph replays them.

The kernel replaces no TPU kernel: the JAX package leaves its products to
XLA. It is bound by operations at the step's shapes; see the source.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_build

LAYOUTS = {"nt": 0, "nn": 1, "tn": 2}
SMS = 132         # the H100's multiprocessors: the grid the plan fills
BK = 32           # K a k-step; must match kBK in csrc/tf32x3_gemm.cu
MAX_SPLITS = 16
# (warpgroups, columns): a block computes 64 * warpgroups rows by columns
TILES = ((2, 128), (2, 64), (1, 64))
# blocks of a tile that share a multiprocessor (shared memory allows two of
# the smallest)
BLOCKS_PER_SM = {(2, 128): 1, (2, 64): 1, (1, 64): 2}
# The cost model of :func:`plan`, fitted to the kernel's own times on an H100
# (every tile and split at the cells' shapes, CUDA graph replays,
# ``scripts/sweep_gemm_tiles.py``; within 9% on average): a wave of blocks
# takes its k-steps times STEP_US plus WAVE_US (the first loads, the
# epilogue); a product split over K adds its second launch, REDUCE_US plus
# REDUCE_US_A_MB a megabyte of partial sums written and read.
STEP_US = {(2, 128): 1.334, (2, 64): 0.922, (1, 64): 0.959}
WAVE_US = {(2, 128): 5.141, (2, 64): 2.727, (1, 64): 2.94}
REDUCE_US = 1.362
REDUCE_US_A_MB = 0.13


class Plan(NamedTuple):
    warpgroups: int       # rows a block: 64 * warpgroups
    columns: int          # columns a block: 64 or 128
    splits: int           # equal runs of whole k-steps, summed in order
    tiles_per_split: int  # k-steps of 32 a split


def blocks(batch: int, m: int, n: int, p: Plan) -> int:
    """The grid's blocks of ``p`` for a batch of ``m x n`` products."""
    return (batch * -(-m // (64 * p.warpgroups)) * -(-n // p.columns)
            * p.splits)


def cost_us(batch: int, m: int, n: int, p: Plan) -> float:
    """The cost model's microseconds for ``p`` (see ``STEP_US``)."""
    tile = (p.warpgroups, p.columns)
    waves = -(-blocks(batch, m, n, p) // (SMS * BLOCKS_PER_SM[tile]))
    us = waves * (p.tiles_per_split * STEP_US[tile] + WAVE_US[tile])
    if p.splits > 1:
        partial_mb = 4 * batch * m * n * (2 * p.splits + 1) / 1e6
        us += REDUCE_US + REDUCE_US_A_MB * partial_mb
    return us


def plan(batch: int, m: int, n: int, k: int) -> Plan:
    """The tile and the split over K for a ``batch`` of ``m x k`` by ``k x
    n`` products, from the shape alone: among the tiles and the numbers of
    splits up to ``MAX_SPLITS`` that divide the k-steps (so every split runs
    the same whole k-steps), those whose grid keeps at least half the
    multiprocessors busy (or makes half the blocks the shape can, where
    that is fewer), the least :func:`cost_us`."""
    if min(batch, m, n, k) < 1:
        raise ValueError(f"gemm: empty product {(batch, m, n, k)}")
    k_tiles = -(-k // BK)
    candidates = [Plan(wg, cols, s, k_tiles // s) for wg, cols in TILES
                  for s in range(1, min(MAX_SPLITS, k_tiles) + 1)
                  if k_tiles % s == 0 and batch * s <= 65535]
    most = max(blocks(batch, m, n, p) for p in candidates)
    filled = [p for p in candidates
              if 2 * blocks(batch, m, n, p) >= min(SMS, most)]
    return min(filled, key=lambda p: cost_us(batch, m, n, p))


def dims(a: torch.Tensor, b: torch.Tensor, layout: str
         ) -> Tuple[int, int, int, int]:
    """``(batch, m, n, k)`` of ``tf32x3_gemm(a, b, layout)``; raises on
    operands that do not fit."""
    if layout not in LAYOUTS:
        raise ValueError(f"gemm: layout must be one of {sorted(LAYOUTS)}, "
                         f"got {layout!r}")
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"gemm: two 2-D or two 3-D operands, got shapes "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    batch = a.shape[0] if a.dim() == 3 else 1
    if a.dim() == 3 and b.shape[0] != batch:
        raise ValueError(f"gemm: batches differ: {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    (ar, ac), (br, bc) = a.shape[-2:], b.shape[-2:]
    m, ka = (ac, ar) if layout == "tn" else (ar, ac)
    n, kb = (br, bc) if layout == "nt" else (bc, br)
    if ka != kb:
        raise ValueError(f"gemm {layout}: inner sizes differ: "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return batch, m, n, ka


def tf32x3_gemm_reference(a: torch.Tensor, b: torch.Tensor, layout: str,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: the float32 ``torch.matmul`` of the layout's
    operands, the bias added after (``torch.addmm`` for a 2-D ``"nt"``
    product with a bias, as ``F.linear`` computes it)."""
    dims(a, b, layout)
    if layout == "nt" and bias is not None and a.dim() == 2:
        return torch.addmm(bias, a, b.t())
    lhs = a.transpose(-1, -2) if layout == "tn" else a
    rhs = b.transpose(-1, -2) if layout == "nt" else b
    out = torch.matmul(lhs, rhs)
    return out if bias is None else out + bias


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cuda_build.load("tf32x3_gemm")
    fn = lib.egopack_tf32x3_gemm
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = i32
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr] + [i32] * 9 + [ptr]
        lib.egopack_tf32x3_gemm_error_string.restype = ctypes.c_char_p
        lib.egopack_tf32x3_gemm_error_string.argtypes = [i32]
    return lib


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel takes it (contiguous); on the CPU as it is, so
    the plain version sees what ``F.linear`` and ``torch.bmm`` saw."""
    return t if t.device.type == "cpu" else t.contiguous()


def _check(a: torch.Tensor, b: torch.Tensor,
           bias: Optional[torch.Tensor], n: int) -> None:
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"gemm: {name} must be float32, got {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"gemm: {name} on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"gemm: {name} must be contiguous")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"gemm: bias of shape {tuple(bias.shape)} for "
                         f"{n} columns")


def tf32x3_gemm(a: torch.Tensor, b: torch.Tensor, layout: str,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``op(a) @ op(b) (+ bias)`` in float32 for the ``layout`` "nt", "nn"
    or "tn": ``(m, n)``, or ``(batch, m, n)`` for 3-D operands.

    On CUDA tensors it launches the kernel with the tiling of :func:`plan`
    and adds one to ``tf32x3_gemm.launches`` per product (a split product's
    second launch, which adds its splits, is not counted); a failed launch
    raises. Tensors on the CPU take :func:`tf32x3_gemm_reference`, because
    no kernel runs there."""
    if a.device.type == "cpu":
        return tf32x3_gemm_reference(a, b, layout, bias)
    out = launch(a, b, layout, bias, plan(*dims(a, b, layout)))
    tf32x3_gemm.launches += 1
    return out


def launch(a: torch.Tensor, b: torch.Tensor, layout: str,
           bias: Optional[torch.Tensor], p: Plan) -> torch.Tensor:
    """The kernel on CUDA tensors with the tiling ``p``, on the current
    stream: :func:`tf32x3_gemm` with ``plan``'s tiling, and
    ``scripts/sweep_gemm_tiles.py`` with every other."""
    batch, m, n, k = dims(a, b, layout)
    _check(a, b, bias, n)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for device {a.device}")
    shape = (batch, m, n) if a.dim() == 3 else (m, n)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    partial = (torch.empty((p.splits, batch, m, n), dtype=torch.float32,
                           device=a.device) if p.splits > 1 else None)
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.egopack_tf32x3_gemm(
            a.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), batch, m, n, k,
            LAYOUTS[layout], p.warpgroups, p.columns, p.splits,
            p.tiles_per_split, stream)
    if err != 0:
        msg = lib.egopack_tf32x3_gemm_error_string(err).decode()
        raise RuntimeError(f"tf32x3_gemm kernel launch failed: {msg}")
    return out


tf32x3_gemm.launches = 0


class _Linear(torch.autograd.Function):
    """``x @ wᵀ (+ bias)`` for ``x (rows, in)``, ``w (out, in)``: the
    forward an "nt" product, the input's gradient ``g @ w`` ("nn"), the
    weight's ``gᵀ @ x`` ("tn"), each only where autograd asks for it."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return tf32x3_gemm(x, w, "nt", bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _dense(g)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = tf32x3_gemm(g, w, "nn")
        if ctx.needs_input_grad[1]:
            gw = tf32x3_gemm(g, x, "tn")
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g.sum(0)
        return gx, gw, gb


class _Matmul(torch.autograd.Function):
    """``a @ w`` for ``a (T, M, F)``, ``w (T, F, H)``: the forward an "nn"
    product, ``a``'s gradient ``g @ wᵀ`` ("nt"), ``w``'s ``aᵀ @ g``
    ("tn"), each only where autograd asks for it."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return tf32x3_gemm(a, w, "nn")

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = _dense(g)
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = tf32x3_gemm(g, w, "nt")
        if ctx.needs_input_grad[1]:
            gw = tf32x3_gemm(a, g, "tn")
        return ga, gw


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` for float32 ``x (..., in)``, every
    product through :func:`tf32x3_gemm`, forward and backward."""
    y = _Linear.apply(_dense(x.reshape(-1, x.shape[-1])), _dense(weight),
                      bias)
    return y.reshape(*x.shape[:-1], weight.shape[0])


def bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, w)`` for float32 ``a (T, M, F)`` and ``w (T, F, H)``,
    every product through :func:`tf32x3_gemm`, forward and backward."""
    return _Matmul.apply(_dense(a), _dense(w))
