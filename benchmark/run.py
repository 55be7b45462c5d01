"""The benchmark of ``egopack_torch``: one run of one cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the cell's step from its configuration with weights and
banks made on the card from ``--seed``, and its feed: batches made on the
card, or the program's loaders over a feature tree written from the seed;
it takes the first steps (the ones the correctness check follows) and a
few more; then it times ``--seconds`` of steps; then it checks the first
steps against the plain reference. The last line of standard output is the result as JSON; the
numbers compared, each beside its limit, are the last lines of standard
error. The card's busy time a step comes from a few stretches of steps
profiled after the window, the card alone; ``--trace 1`` also profiles the
host's operations and reports the per-layer metrics instead of the
end-to-end ones.

It needs an NVIDIA card and exits with an error without one. The program's
CUDA kernels are built into ``egopack_torch/_build/`` inside the checkout
at their first use.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "egopack_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from benchmark.harness.cell import check_lines, run_cell
    from benchmark.harness.manifest import Manifest

    manifest = Manifest()
    need = manifest.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"run.py: {args.workload} needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    out = run_cell(manifest, args.workload, args.seed, args.seconds,
                   bool(args.trace), device, STARTED, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"run.py: loaded {bad}, which the benchmark must not load")
        return 3
    for line in check_lines(out["checks"]):
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
