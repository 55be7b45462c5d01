"""Local grid sweeps of the wandb-sweep YAMLs under ``experiments/`` (the
port's counterpart of ``egopack_tpu/sweep.py``).

The reference launches its experiments with ``wandb sweep <yaml>``
(reference README.md:36). This runner expands the same schema (a grid of
``parameters.*.values`` and a ``command`` template) and runs each
configuration in turn as the port's entry point: the YAMLs name the JAX
package's scripts (``program: main_temporal.py``), which map to
``python -m egopack_torch.main_temporal`` (``main_egopack.py`` likewise),
so a sweep of the port never runs JAX. The YAML is read by the port's own
``config.yaml_subset``.

Usage::

    python -m egopack_torch.sweep experiments/mtl.yaml [--dry-run] [key=value ...]
"""

from __future__ import annotations

import itertools
import os.path as osp
import subprocess
import sys
from typing import Any, Dict, List, Sequence

from .config.yaml_subset import load_file

# the scripts the experiments name -> the port's modules
PROGRAMS = {"main_temporal.py": "egopack_torch.main_temporal",
            "main_egopack.py": "egopack_torch.main_egopack"}


def _format_value(v: Any) -> str:
    if isinstance(v, list):
        return "[" + ",".join(str(x) for x in v) + "]"
    return str(v)


def expand_grid(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    params = spec.get("parameters", {})
    keys = list(params.keys())
    grids = [params[k]["values"] if "values" in params[k]
             else [params[k].get("value")] for k in keys]
    return [dict(zip(keys, combo)) for combo in itertools.product(*grids)]


def program_module(program: str) -> str:
    """The port's module for the script a sweep names."""
    name = osp.basename(program)
    if name not in PROGRAMS:
        raise ValueError(f"program {program!r}: the port runs "
                         f"{sorted(PROGRAMS)}")
    return PROGRAMS[name]


def build_commands(spec: Dict[str, Any],
                   extra: Sequence[str] = ()) -> List[List[str]]:
    """One command per grid point: ``python -m <module>``, the template's
    literal arguments (every ``${...}`` placeholder of wandb is dropped;
    the grid's overrides play ``${args}``), the grid's ``key=value``
    overrides, then ``extra``."""
    module = program_module(spec["program"])
    template = spec.get("command", ["${env}", "python3", "${program}",
                                    "${args_no_hyphens}"])
    static_args = [a for a in template
                   if not (a.startswith("${") and a.endswith("}"))
                   and a not in ("python3", "python")]
    commands = []
    for combo in expand_grid(spec):
        overrides = [f"{k}={_format_value(v)}" for k, v in combo.items()]
        commands.append([sys.executable, "-m", module, *static_args,
                         *overrides, *extra])
    return commands


def main(argv: List[str] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    dry = "--dry-run" in argv
    argv = [a for a in argv if a != "--dry-run"]
    yaml_path, *extra = argv
    spec = load_file(yaml_path)
    commands = build_commands(spec, extra)
    print(f"Sweep '{spec.get('name', yaml_path)}': {len(commands)} runs")
    for i, cmd in enumerate(commands):
        print(f"[{i + 1}/{len(commands)}] {' '.join(cmd)}", flush=True)
        if dry:
            continue
        ret = subprocess.call(cmd)
        if ret != 0:
            print(f"Run {i + 1} failed with exit code {ret}", file=sys.stderr)
            return ret
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
