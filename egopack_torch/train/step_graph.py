"""Replay the train step's forward, backward and norms from a CUDA graph.

``StepGraphs(compute, ranks)`` wraps ``compute(args, *flags) -> (grads,
logs)``: the part of a train step from its inputs to the optimizer. A call
``graphs(args, *flags)`` takes one of two roads, by what the call shows:

- eager, ``compute(args, *flags)`` as written: a call whose tensors are not
  on the card, a call on a grid of more than one rank (``ranks()``; the
  collectives stay out of graphs), the first ``EAGER_CALLS`` calls of a
  signature, and every call of a signature that finds ``MAX_GRAPHS``
  signatures captured;
- replay: the next call of a signature captures ``compute`` on copies of
  its input tensors into one ``torch.cuda.CUDAGraph``; that call and each
  later one of the signature copies its input tensors into those copies
  and replays the graph.

A signature is the call's structure: the dicts, lists and tuples of
``args`` with their keys; each tensor's shape, dtype and device; each
generator's device; each other leaf by value where it is a number, a
string or None, else by identity (the prototype banks); ``flags``; and the
float32 matmul precision. An entry keyed by identity lives as long as its
objects: once one is gone, its graph goes and frees its place. An object
keyed by identity must keep its tensors: the graph reads them where they
were at the capture. A generator off the card, or another object that
takes no weak reference, keeps the call eager. What ``compute`` reads
beyond its arguments stays as the capture found it: the parameters, read
in place and updated in place by the caller, and the modules' settings
(GraphONE's kNN implementation, say), which a step made anew captures
anew.

The eager calls are the warm-up that the capture needs: they build what it
forbids (the device constants cached per signature, the kernels' libraries,
cuBLAS handles, autograd's state). The graph draws from generators of its
own, registered with it: a replay takes each caller's generator state in,
and gives the advanced state back. So a replay draws the dropout masks an
eager call would have drawn at that point of the caller's stream, and any
generator replays the graph (the phase-1 driver draws one an epoch).

A replay returns the graph's own gradient buffers, which the caller reads
before its next call, and fresh log tensors: one copy out of the buffer the
graph packs them into. The port's launch counters (``cosine_knn.launches``,
``fused_adam.launches``, ``sum_squares.launches``,
``tf32x3_gemm.launches``) count executions: a
capture adds nothing, and each replay adds the launches its graph holds.
The span ``egopack.replay`` marks each ``replay()``.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.fused_adam import fused_adam
from ..ops.gemm import tf32x3_gemm
from ..ops.knn_topk import cosine_knn
from ..ops.sum_squares import sum_squares
from ..tracing import span

EAGER_CALLS = 3      # calls of a signature run eagerly before its capture
MAX_GRAPHS = 4       # signatures captured at once
MAX_SIGNATURES = 16  # signatures counted at once
# with a ``launches`` count
COUNTERS = (cosine_knn, fused_adam, sum_squares, tf32x3_gemm)
_VALUES = (bool, int, float, str, type(None))

Grads = Dict[str, torch.Tensor]
Logs = Dict[str, torch.Tensor]


def _flatten(tree: Any, leaves: list) -> Any:
    """The structure of ``tree`` (nested dicts, lists and tuples), its
    leaves appended to ``leaves`` in order."""
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if type(tree) in (list, tuple):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    return None


def _unflatten(tree: Any, leaves) -> Any:
    """``tree`` with its leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def capture(step: Callable[[], Any], generators: Sequence[torch.Generator]
            ) -> Tuple[Any, Any]:
    """``step()`` captured into a ``torch.cuda.CUDAGraph`` on a side
    stream, with ``generators`` registered: ``(graph, what step
    returned)``. Nothing has run on the card yet."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        out = step()
    return graph, out


class _Entry:
    """One signature: its calls so far and, once captured, its graph, the
    graph's input buffers, generators and outputs, and the launches it
    holds."""

    def __init__(self, refs: List[weakref.ref]):
        self.refs = refs
        self.calls = 0
        self.graph: Any = None
        self.inputs: List[torch.Tensor] = []
        self.generators: List[torch.Generator] = []
        self.grads: Optional[Grads] = None
        self.packed: Optional[torch.Tensor] = None
        self.layout: List[Tuple[str, torch.Size, torch.dtype]] = []
        self.counts: Tuple[int, ...] = ()

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)


class StepGraphs:
    """The table of a step's signatures; see the module docstring."""

    DEVICE_TYPE = "cuda"  # where a step may be captured
    captures = 0          # graphs captured in this process

    def __init__(self, compute: Callable[..., Tuple[Grads, Logs]],
                 ranks: Callable[[], int]):
        self.compute = compute
        self.ranks = ranks
        self.entries: Dict[tuple, _Entry] = {}

    def __call__(self, args: tuple, *flags) -> Tuple[Grads, Logs]:
        leaves: list = []
        structure = _flatten(args, leaves)
        entry = self._entry(leaves, (structure, flags))
        if entry is None:
            return self.compute(args, *flags)
        if entry.graph is None:
            entry.calls += 1
            if entry.calls <= EAGER_CALLS:
                return self.compute(args, *flags)
            self._drop_gone()
            if sum(e.graph is not None
                   for e in self.entries.values()) >= MAX_GRAPHS:
                return self.compute(args, *flags)
            self._capture(entry, args, leaves, flags)
        return self._replay(entry, leaves)

    def _entry(self, leaves: list, head: tuple) -> Optional[_Entry]:
        """The call's entry, made at its signature's first call; None where
        the call stays eager whatever its count."""
        if self.ranks() > 1:
            return None
        parts, refs, on_card = [], [], False
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                if leaf.device.type != self.DEVICE_TYPE:
                    return None
                on_card = True
                parts.append((tuple(leaf.shape), leaf.dtype, leaf.device))
            elif isinstance(leaf, torch.Generator):
                if leaf.device.type != self.DEVICE_TYPE:
                    return None
                parts.append((torch.Generator, leaf.device))
            elif isinstance(leaf, _VALUES):
                parts.append((type(leaf), leaf))
            else:
                try:
                    refs.append(weakref.ref(leaf))
                except TypeError:
                    return None
                parts.append(id(leaf))
        if not on_card:
            return None
        key = head + (tuple(parts), torch.get_float32_matmul_precision())
        entry = self.entries.get(key)
        if entry is not None and entry.alive():
            return entry
        # a new signature, or an id that a gone object left to a new one
        self._drop_gone()
        if len(self.entries) >= MAX_SIGNATURES:
            return None
        entry = self.entries[key] = _Entry(refs)
        return entry

    def _drop_gone(self) -> None:
        """Drop the entries whose objects are gone, with their graphs."""
        gone = [k for k, e in self.entries.items() if not e.alive()]
        if self.DEVICE_TYPE == "cuda" and any(
                self.entries[k].graph is not None for k in gone):
            torch.cuda.synchronize()  # its last replay may still be queued
        for k in gone:
            del self.entries[k]

    def _capture(self, entry: _Entry, args: tuple, leaves: list,
                 flags: tuple) -> None:
        inputs = [x.detach().clone() if isinstance(x, torch.Tensor) else
                  torch.Generator(x.device) if isinstance(x, torch.Generator)
                  else x for x in leaves]
        static_args = _unflatten(args, iter(inputs))
        generators = [x for x in inputs if isinstance(x, torch.Generator)]

        def step():
            grads, logs = self.compute(static_args, *flags)
            keys = sorted(logs)
            packed = (torch.cat([logs[k].detach().reshape(-1).float()
                                 for k in keys]) if keys else None)
            return grads, packed, [(k, logs[k].shape, logs[k].dtype)
                                   for k in keys]

        before = [c.launches for c in COUNTERS]
        graph, (grads, packed, layout) = capture(step, generators)
        entry.counts = tuple(c.launches - n for c, n in zip(COUNTERS, before))
        for c, n in zip(COUNTERS, before):
            c.launches = n
        entry.graph, entry.grads = graph, grads
        entry.packed, entry.layout = packed, layout
        entry.inputs = [x for x in inputs if isinstance(x, torch.Tensor)]
        entry.generators = generators
        StepGraphs.captures += 1

    @staticmethod
    def _replay(entry: _Entry, leaves: list) -> Tuple[Grads, Logs]:
        tensors = (x for x in leaves if isinstance(x, torch.Tensor))
        for buf, x in zip(entry.inputs, tensors):
            buf.copy_(x)
        callers = [x for x in leaves if isinstance(x, torch.Generator)]
        for own, g in zip(entry.generators, callers):
            own.set_state(g.get_state())
        with span("egopack.replay"):
            entry.graph.replay()
        for own, g in zip(entry.generators, callers):
            g.set_state(own.get_state())
        for c, n in zip(COUNTERS, entry.counts):
            c.launches += n
        logs: Logs = {}
        if entry.packed is not None:
            flat, off = entry.packed.clone(), 0
            for key, shape, dtype in entry.layout:
                n = math.prod(shape)
                logs[key] = flat[off:off + n].view(shape).to(dtype)
                off += n
        return entry.grads, logs
