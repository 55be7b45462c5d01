"""Hydra-style configuration (the port's copy of
``egopack_tpu/config/loader.py``).

The subset of hydra + OmegaConf that the reference relies on
(reference ``main_temporal.py:137``, sweep YAMLs emitting ``key=value``
overrides):

- a config tree rooted at ``configs/defaults.yaml``
- a ``defaults:`` list with config groups (``model: graph``) and ``_self_``
- ``${path.to.key}`` interpolation (``T_max: ${num_epochs}``)
- dotted overrides ``a.b.c=value``, ``+key=value``, and group overrides
  ``model=graph`` and ``group/subgroup=name``
- values typed with YAML 1.1 semantics by ``yaml_subset``, then strings
  such as ``'1e-5'`` made floats, as hydra does
"""

from __future__ import annotations

import copy
import os
import os.path as osp
import re
from typing import Any, Dict, List, Optional

from .yaml_subset import load_file, parse_scalar


class ConfigNode(dict):
    """A dict with attribute access, mirroring OmegaConf's DictConfig."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce(obj: Any) -> Any:
    # YAML 1.1 reads '1e-5' (no dot) as a string; OmegaConf/hydra treat it
    # as a float
    if isinstance(obj, str) and _NUM_RE.match(obj):
        return float(obj)
    return obj


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigNode({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return _coerce(obj)


def to_container(cfg: Any) -> Any:
    """Plain-dict view of a config tree (OmegaConf.to_container)."""
    if isinstance(cfg, dict):
        return {k: to_container(v) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [to_container(v) for v in cfg]
    return cfg


def _merge(dst: ConfigNode, src: Dict[str, Any]) -> ConfigNode:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = _wrap(v)
    return dst


def _get_path(cfg: Any, path: str) -> Any:
    node = cfg
    for part in path.split("."):
        node = node[part]
    return node


def _set_path(cfg: ConfigNode, path: str, value: Any) -> None:
    parts = path.split(".")
    node = cfg
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            node[part] = ConfigNode()
        node = node[part]
    node[parts[-1]] = _wrap(value)


_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve_interpolations(cfg: ConfigNode) -> None:
    """Resolve ``${a.b}`` references against the config root."""

    def resolve_value(v: Any) -> Any:
        if isinstance(v, str):
            full = _INTERP_RE.fullmatch(v)
            if full:
                return resolve_value(_get_path(cfg, full.group(1)))
            return _INTERP_RE.sub(
                lambda m: str(resolve_value(_get_path(cfg, m.group(1)))), v)
        return v

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            for k in list(node.keys()):
                node[k] = walk(node[k])
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        return resolve_value(node)

    walk(cfg)


def _load_yaml(path: str) -> Dict[str, Any]:
    return load_file(path) or {}


def _compose(config_dir: str, name: str,
             group_overrides: Dict[str, str]) -> ConfigNode:
    """Compose a config file with its ``defaults:`` list (depth first).

    ``name`` is relative to ``config_dir``; nested group entries resolve
    relative to the current file's directory (hydra: the group
    ``temporal_pooling`` inside ``model/graph.yaml`` loads
    ``model/temporal_pooling/<choice>.yaml``). Overrides address groups by
    absolute path (``model/temporal_pooling=trn``)."""
    raw = _load_yaml(osp.join(config_dir, name + ".yaml"))
    defaults: List[Any] = raw.pop("defaults", [])
    base = osp.dirname(name)

    cfg = ConfigNode()
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            _merge(cfg, raw)
            self_merged = True
            continue
        if isinstance(entry, dict):
            (group, choice), = entry.items()
            group = str(group)
            if group.startswith("override "):
                continue  # hydra logging overrides
            abs_group = osp.join(base, group) if base else group
            # the absolute path first, without consuming the bare-name form
            # meant for another group with the same last segment
            if abs_group in group_overrides:
                choice = group_overrides.pop(abs_group)
            elif group in group_overrides:
                choice = group_overrides.pop(group)
            if choice is None:
                continue
            sub = _compose(config_dir, osp.join(abs_group, str(choice)),
                           group_overrides)
            _merge(cfg.setdefault(group.split("/")[-1], ConfigNode()), sub)
    if not self_merged:
        _merge(cfg, raw)
    return cfg


def compose(config_dir: str, config_name: str = "defaults",
            overrides: Optional[List[str]] = None) -> ConfigNode:
    """The final config: defaults tree + group choices + dotted overrides
    (``["model/temporal_pooling=trn", "k=1", "model.hidden_size=1024",
    "enabled_tasks=[ar,oscc,lta]"]``)."""
    group_overrides: Dict[str, str] = {}
    value_overrides: List[tuple] = []
    for ov in overrides or []:
        ov = ov.lstrip("+")
        if "=" not in ov:
            raise ValueError(f"Malformed override (expected key=value): {ov!r}")
        key, _, raw = ov.partition("=")
        raw = raw.strip().strip("'\"")
        if "/" in key or ("." not in key
                          and osp.isdir(osp.join(config_dir, key))):
            group_overrides[key] = raw
        else:
            value_overrides.append((key, parse_scalar(raw, f"override {key}")))

    cfg = _compose(config_dir, config_name, group_overrides)
    # group overrides that matched no defaults entry: compose directly
    for group, choice in group_overrides.items():
        sub = _compose(config_dir, osp.join(group, choice), {})
        node = cfg
        for part in group.split("/")[:-1]:
            node = node.setdefault(part, ConfigNode())
        _merge(node.setdefault(group.split("/")[-1], ConfigNode()), sub)

    for key, value in value_overrides:
        _set_path(cfg, key, value)

    _resolve_interpolations(cfg)
    return cfg


def default_config_dir() -> str:
    """``EGOPACK_CONFIG_DIR`` if set, else the repository's ``configs/``."""
    env = os.environ.get("EGOPACK_CONFIG_DIR")
    if env:
        return env
    return osp.join(osp.dirname(osp.dirname(osp.dirname(
        osp.abspath(__file__)))), "configs")
