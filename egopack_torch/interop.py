"""Carry weights between the flax parameter tree and the port's modules.

Flax tree, as numpy arrays: top-level keys ``temporal_graph``,
``task/recognition``, ``task/lta``, ``task/oscc``, ``task/pnr`` and, in
phase 2, ``graphone`` and (trainable banks) ``graphone_banks``, then the
module path (``pooling/fc0/kernel``, ``sage0/lin_r/kernel``,
``cls0/TLinear_0/bias``, ``aux_ar_cls/TLinear_0/kernel``, ``gn1/scale``,
``w_l``, ``ar``, ...). GraphONE's stacked stage weights and the bank values
keep their flax names and layout: no transpose.

Torch state: ``{dotted name: tensor}``, the names of the port's
``nn.Module`` tree (``temporal_graph.pooling.fc0.weight``,
``task.recognition.cls0.TLinear_0.bias``, ``temporal_graph.gn1.weight``,
``graphone.w_l``, ``graphone_banks.ar``).
A flax ``kernel (in, out)`` is a torch ``weight (out, in)``; a flax ``scale``
is a torch ``weight`` of one dimension. ``to_flax(from_flax(p))`` returns
``p`` bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch


def _split(name: str) -> List[str]:
    """Dotted torch name -> flax path components, with ``task/<name>`` kept
    as one top-level key."""
    parts = name.split(".")
    if parts[0] == "task" and len(parts) > 2:
        parts = [f"task/{parts[1]}"] + parts[2:]
    return parts


def top_level_key(name: str) -> str:
    """The flax top-level key a torch parameter belongs to
    (``temporal_graph``, ``task/recognition``, ...)."""
    return _split(name)[0]


def flax_path(name: str, ndim: int) -> List[str]:
    """The flax path of the torch tensor ``name`` of ``ndim`` dimensions
    (``temporal_graph.pooling.fc0.weight`` of 2 ->
    ``[temporal_graph, pooling, fc0, kernel]``)."""
    parts = _split(name)
    if parts[-1] == "weight":
        parts[-1] = "kernel" if ndim == 2 else "scale"
    return parts


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves) -> torch state (CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        parts = "/".join(path).split("/")
        a = np.asarray(leaf)
        if parts[-1] == "kernel":
            a, parts[-1] = a.T, "weight"
        elif parts[-1] == "scale":
            parts[-1] = "weight"
        name = ".".join(parts)
        if name in out:
            raise ValueError(f"two flax leaves map to {name}")
        out[name] = torch.from_numpy(np.array(a, order="C"))  # a copy
    return out


def to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Torch state -> flax parameter tree (numpy leaves)."""
    tree: Dict[str, Any] = {}
    for name, tensor in state.items():
        a = tensor.detach().cpu().numpy()
        parts = flax_path(name, a.ndim)
        leaf = parts[-1]
        if leaf == "kernel":
            a = a.T
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        if leaf in node:
            raise ValueError(f"two torch tensors map to {name}")
        node[leaf] = np.ascontiguousarray(a)
    return tree
