"""``_target_`` instantiation (the port's counterpart of
``egopack_tpu/config/instantiate.py``, mirroring ``hydra.utils.instantiate``).

A config node with a ``_target_`` names a callable; the other keys become
keyword arguments, call-site ones taking precedence; ``_recursive_=False``
leaves nested nodes as configs. The configs' targets name ``egopack_tpu``
classes (``configs/model/graph.yaml:2``, ``configs/dataset_*/ego4d.yaml:2``,
``configs/defaults.yaml:48,59``): :data:`TARGETS` maps each to the port's
counterpart. A target missing from the table raises; no ``egopack_tpu``
module is ever imported.
"""

from __future__ import annotations

import importlib
from typing import Any, Optional

from .loader import ConfigNode

# egopack_tpu target -> the port's callable
TARGETS = {
    "egopack_tpu.models.backbone.TemporalGraph":
        "egopack_torch.config.instantiate.temporal_graph",
    "egopack_tpu.models.pooling.TRNPooling":
        "egopack_torch.models.pooling.TRNPooling",
    "egopack_tpu.data.fho.Ego4dRecognitionDataset":
        "egopack_torch.data.fho.Ego4dRecognitionDataset",
    "egopack_tpu.data.fho.Ego4dLTADataset":
        "egopack_torch.data.fho.Ego4dLTADataset",
    "egopack_tpu.data.osccpnr.Ego4dOSCCDataset":
        "egopack_torch.data.osccpnr.Ego4dOSCCDataset",
    "egopack_tpu.data.osccpnr.Ego4dPNRDataset":
        "egopack_torch.data.osccpnr.Ego4dPNRDataset",
    "egopack_tpu.train.optim.adam": "egopack_torch.train.optim.adam",
    "egopack_tpu.train.optim.cosine_annealing":
        "egopack_torch.train.optim.cosine_annealing",
}


def locate(path: str) -> Any:
    """The port's callable for the ``_target_`` ``path`` (:data:`TARGETS`)."""
    if path not in TARGETS:
        raise ValueError(f"no counterpart of {path!r} in the port "
                         "(egopack_torch/config/instantiate.py:TARGETS)")
    module_path, _, attr = TARGETS[path].rpartition(".")
    return getattr(importlib.import_module(module_path), attr)


def instantiate(cfg: Any, *args: Any, _recursive_: bool = True,
                **kwargs: Any) -> Any:
    if cfg is None:
        return None
    if not isinstance(cfg, dict):
        raise TypeError(f"instantiate expects a config node, got {type(cfg)}")
    if "_target_" not in cfg:
        raise ValueError("Config node has no _target_ key")
    recursive = cfg.get("_recursive_", _recursive_)
    call_kwargs = {}
    for k, v in cfg.items():
        if k in ("_target_", "_recursive_"):
            continue
        if recursive and isinstance(v, dict) and "_target_" in v:
            v = instantiate(v)
        call_kwargs[k] = v
    call_kwargs.update(kwargs)
    return locate(cfg["_target_"])(*args, **call_kwargs)


def temporal_graph(input_size: int, hidden_size: int = 1024, depth: int = 3,
                   pre_dropout: float = 0.0,
                   temporal_pooling: Optional[Any] = None,
                   num_segments: int = 8, propagate_dtype: Optional[Any] = None,
                   device=None):
    """The backbone from its config node. The JAX ``TemporalGraph`` takes
    its pooling as a config node and instantiates it with
    ``(input_size, hidden_size, num_segments)`` and its ``propagate_dtype``
    (``egopack_tpu/models/backbone.py:44-62``); the port's takes a module,
    built here the same way. ``propagate_dtype`` is ``None``, ``"float32"``,
    ``"bfloat16"`` (``+model.propagate_dtype=bfloat16``) or a
    ``torch.dtype``."""
    from ..models.backbone import TemporalGraph
    from ..models.layers import resolve_dtype

    propagate_dtype = resolve_dtype(propagate_dtype)
    if isinstance(temporal_pooling, dict):
        temporal_pooling = instantiate(temporal_pooling, input_size,
                                       hidden_size, num_segments,
                                       dtype=propagate_dtype, device=device)
    return TemporalGraph(input_size, hidden_size, depth, pre_dropout,
                         temporal_pooling, num_segments, propagate_dtype,
                         device=device)


__all__ = ["instantiate", "locate", "ConfigNode", "TARGETS"]
