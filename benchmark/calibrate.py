"""Readings that the limits of ``correct`` are set from, for one cell, on
the card, at the cell's own size:

- ``sound``: the program's first steps against the reference, one seed
  each;
- ``control``: the reference itself in the program's place, computed one
  precision lower (TF32 products for the configurations' float32), against
  the reference;
- each named fault (``harness/faults.py``) planted in the program.

    python3 benchmark/calibrate.py --workload mtl-step --seeds 1 2 3 \
        --control-seeds 1 2 3 --faults half_batch --fault-seeds 1 2 3

Prints one JSON line per reading. Training needs no measured window: the
numbers come from the checked first steps alone.
"""

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--leaves", action="store_true",
                    help="also print the leaves behind each gap")
    args = ap.parse_args()

    import torch
    from benchmark.harness import cell as cells
    from benchmark.harness import check, faults, inputs
    from benchmark.harness.manifest import Manifest

    if not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cfg, traffic, kind = Manifest().setting(args.workload)

    def emit(kind, seed, values, leaves=None):
        line = {"workload": args.workload, "kind": kind, "seed": seed,
                "numbers": values}
        if args.leaves and leaves is not None:
            line["leaves"] = leaves
        print(json.dumps(line), flush=True)

    def program(seed, fault=None):
        faults.tf32(False)
        seeds = inputs.stream_seeds(seed)
        feed, step, rec = cells.program_first_steps(cfg, traffic, kind,
                                                    seeds, device, fault)
        feed.close()
        del feed, step
        faults.restore()
        gc.collect()
        torch.cuda.empty_cache()
        run = cells.reference_run(cfg, traffic, kind, seeds, device,
                                  rec.knn, follow=rec.grads)
        return check.numbers(cfg, rec, run), check.worst_leaves(rec, run)

    for seed in args.seeds:
        emit("sound", seed, *program(seed))
    for name in args.faults:
        for seed in args.fault_seeds:
            emit(name, seed, *program(seed, faults.FAULTS[name]))
    for seed in args.control_seeds:
        emit("control", seed, cells.control_numbers(
            cfg, traffic, kind, inputs.stream_seeds(seed), device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
