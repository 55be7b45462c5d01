"""Aggregate run metrics across seeds, the reference's protocol (the port's
counterpart of ``egopack_tpu/aggregate.py``).

The reference reports every metric as the mean of three runs (reference
README.md:36-39, sweep seeds 65, 72, 97). Each run writes
``<output_dir>/<run>/metrics.jsonl`` and ``config.json`` (``RunLogger``);
this tool groups the runs by their config without the seed, takes each
run's last value of each metric and prints the mean and standard deviation
across the seeds.

Usage::

    python -m egopack_torch.aggregate outputs/ [--metric val/oscc/accuracy]
"""

from __future__ import annotations

import json
import os
import os.path as osp
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def load_runs(output_dir: str) -> List[Tuple[dict, Dict[str, float]]]:
    """(config, last value of each numeric metric) of every run directory
    under ``output_dir`` with both files."""
    runs = []
    for name in sorted(os.listdir(output_dir)):
        run_dir = osp.join(output_dir, name)
        metrics_path = osp.join(run_dir, "metrics.jsonl")
        config_path = osp.join(run_dir, "config.json")
        if not (osp.exists(metrics_path) and osp.exists(config_path)):
            continue
        with open(config_path) as f:
            config = json.load(f)
        final: Dict[str, float] = {}
        with open(metrics_path) as f:
            for line in f:
                for k, v in json.loads(line).items():
                    if k not in ("step", "time") \
                            and isinstance(v, (int, float)):
                        final[k] = float(v)  # the last record wins
        if final:
            runs.append((config, final))
    return runs


def _group_key(config: dict) -> str:
    return json.dumps({k: v for k, v in config.items() if k != "seed"},
                      sort_keys=True, default=str)


def _flatten(d: dict, prefix: str = "") -> Dict[str, str]:
    out: Dict[str, str] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = json.dumps(v, default=str)
    return out


def _distinguishing_keys(rep_configs: List[dict]) -> List[str]:
    """Flattened config keys whose values differ between groups, so that a
    sweep over, say, ``graphone.depth`` keeps one label per value."""
    flats = [_flatten(c) for c in rep_configs]
    keys = set().union(*(f.keys() for f in flats))
    return sorted(k for k in keys
                  if k != "seed" and len({f.get(k) for f in flats}) > 1)


def aggregate(output_dir: str,
              metric: Optional[str] = None) -> Dict[str, dict]:
    """``{label: {metric: {"mean", "std", "n"}}}`` over the groups of runs
    that differ only in their seed."""
    groups: Dict[str, List[Tuple[dict, Dict[str, float]]]] = defaultdict(list)
    for config, final in load_runs(output_dir):
        groups[_group_key(config)].append((config, final))
    diff_keys = _distinguishing_keys([runs[0][0] for runs in groups.values()])
    out: Dict[str, dict] = {}
    for runs in groups.values():
        configs = [c for c, _ in runs]
        seeds = sorted(c.get("seed") for c in configs)
        flat0 = _flatten(configs[0])
        sweep = " ".join(f"{k}={flat0.get(k)}" for k in diff_keys)
        label = "{}{}(seeds {})".format(
            "-".join(map(str, configs[0].get("enabled_tasks", ["?"]))),
            f" [{sweep}] " if sweep else "", seeds)
        metrics: Dict[str, dict] = {}
        for m in sorted(set().union(*(f.keys() for _, f in runs))):
            if metric and m != metric:
                continue
            vals = [f[m] for _, f in runs if m in f]
            metrics[m] = {"mean": float(np.mean(vals)),
                          "std": float(np.std(vals)), "n": len(vals)}
        out[label] = metrics
    return out


def main(argv=None) -> Dict[str, dict]:
    argv = list(argv if argv is not None else sys.argv[1:])
    metric = None
    if "--metric" in argv:
        i = argv.index("--metric")
        metric = argv[i + 1]
        del argv[i:i + 2]
    result = aggregate(argv[0] if argv else "outputs", metric)
    for label, metrics in result.items():
        print(f"== {label}")
        for m, s in metrics.items():
            print(f"  {m}: {s['mean']:.4f} ± {s['std']:.4f} (n={s['n']})")
    return result


if __name__ == "__main__":
    main()
