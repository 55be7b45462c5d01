"""Tiny widths of both configurations, for runs on the CPU."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"feature_dim": 48, "hidden_size": 32, "tp_hidden_size": 32,
        "batch_size": 4}
TINY_PHASE2 = {**TINY, "banks": {"rows": 256, "valid": 200},
               "graphone": {"k": 4, "depth": 3, "hidden_size": 32,
                            "residual": True, "distance_func": "cosine",
                            "freeze": True}}
OVERRIDES = {"mtl-step": TINY, "novel-oscc-step": TINY_PHASE2, "mtl-loop": TINY}
# the driver's loop over the loaders, a feed kind that BENCHMARK.json holds
# no cell of: the tests give it one
LOOP_CELL = {"name": "mtl-loop", "config": "egopack-mtl-ar-lta-pnr",
             "traffic": "driver_loop", "chips": 1,
             "why": "the phase-1 step fed by the loaders"}


def manifest():
    """The benchmark's manifest, with ``LOOP_CELL`` among its cells."""
    from benchmark.harness.manifest import Manifest
    m = Manifest()
    if all(w["name"] != LOOP_CELL["name"] for w in m.data["workloads"]):
        m.data["workloads"].append(dict(LOOP_CELL))
    return m


def run_tiny(cell: str, seed: int = 5, fault=None, traced: bool = False,
             seconds: float = 1.0) -> dict:
    """One run of ``cell`` on the CPU at tiny widths."""
    import torch
    from benchmark.harness.cell import run_cell
    return run_cell(manifest(), cell, seed, seconds, traced,
                    torch.device("cpu"), time.perf_counter(),
                    overrides=OVERRIDES[cell], fault=fault,
                    log=lambda line: None)


if __name__ == "__main__":  # a run's path in a fresh interpreter
    out = run_tiny(sys.argv[1])
    print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
