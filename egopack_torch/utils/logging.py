"""Run logging: console + JSONL metrics with wandb-compatible run names
(the port's copy of ``egopack_tpu/utils/logging.py``).

``format_run_name`` reproduces the reference's ``format_wandb_run_name``
pattern substitution on the flattened config (reference
``utils/wandb.py:5-24``); ``RunLogger`` writes one directory per run with
``config.json`` and the ``metrics.jsonl`` records."""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("egopack_torch")


def flatten_cfg(d: Dict[str, Any], parent_key: str = "",
                sep: str = ".") -> Dict[str, Any]:
    items = {}
    for k, v in d.items():
        key = parent_key + sep + k if parent_key else k
        if isinstance(v, dict):
            items.update(flatten_cfg(v, key, sep))
        elif isinstance(v, list):
            items[key] = "-".join(str(x) for x in v)
        else:
            items[key] = v
    return items


def format_run_name(pattern: Optional[str], cfg: Dict[str, Any]) -> Optional[str]:
    """Substitute ``{dotted.key}`` tokens from the flattened config (plain
    token replacement: ``str.format`` would read ``{graphone.depth}`` as
    attribute access)."""
    if pattern is None:
        return None
    out = pattern
    for k, v in flatten_cfg(cfg).items():
        out = out.replace("{" + k + "}", str(v))
    return out


class RunLogger:
    """Console + metrics.jsonl; mirrors wandb.log's (dict, step) interface.
    Every run gets its own directory (``<name>-2``, ... when the name is
    taken), as every wandb run gets its own id."""

    def __init__(self, output_dir: str, run_name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None):
        self.run_name = run_name or time.strftime("run_%Y%m%d_%H%M%S")
        self.dir = osp.join(output_dir, self.run_name)
        if osp.exists(self.dir):
            i = 2
            while osp.exists(f"{self.dir}-{i}"):
                i += 1
            self.dir = f"{self.dir}-{i}"
        os.makedirs(self.dir)
        self._f = open(osp.join(self.dir, "metrics.jsonl"), "a")
        if config is not None:
            with open(osp.join(self.dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"step": step, "time": time.time()}
        record.update({k: _scalar(v) for k, v in metrics.items()})
        self._f.write(json.dumps(record, default=str) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class NullLogger:
    """No-op RunLogger stand-in."""

    dir = os.devnull

    def log(self, metrics, step=None):
        pass

    def close(self):
        pass


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
