#!/usr/bin/env python3
"""Time versions of the cosine-kNN kernel against each other on one card.

    python3 scripts/bench_knn_versions.py new=. old=_checkout/parent

Each ``label=root`` names a checkout that holds an ``egopack_torch``
package; its ``ops/knn_topk.py`` wrapper and ``ops/csrc/knn_topk.cu`` are
loaded under a name of their own and built into that checkout's
``egopack_torch/_build``. The SASS of each version's pass 1 is counted
first. Every version is then held against the plain version (distances
within 1e-5, indices equal but for near-ties; a version that disagrees is
reported so and timed all the same, for variants made to take a part of
the kernel out), and all are timed in turns (the given order, then the
reverse) at T=3, M=64, F=1024, k=8 for P=2048 (2010 valid rows a bank, as
the phase-2 step's banks) and P=55,040 (50,000 valid), the latter on two
draws of inputs. Each window is ``chip_smoke.launch_ms`` over 20 calls,
with the two passes apart and its profiled windows' event counts, and the
card's SM and memory clocks, power draw and temperature are read by
``nvidia-smi`` before and after it. The last
line is a JSON object of every window.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# the second P=55,040 draw: new inputs in new memory (the first draw stays
# allocated), to tell a time that follows the data or its placement from
# one that follows the kernel
SHAPES = {"P=2048": (2048, 2010), "P=55040": (55040, 50000),
          "P=55040, second draw": (55040, 50000)}
ITERS = 20


def load_wrapper(root: Path, name: str):
    """``egopack_torch.ops.knn_topk`` of the checkout at ``root``, imported
    as the package ``name``."""
    pkg = root.resolve() / "egopack_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.knn_topk")


def sass_summary(wrapper) -> str:
    """What pass 1 (``knn_partial``) of a version's built library compiled
    to: its count of each tensor-core, copy and shared-memory load
    instruction in the SASS (``cuobjdump -sass``) and its registers
    (``cuobjdump -res-usage``)."""
    build = wrapper.cuda_build
    lib = str(build.library_path("knn_topk"))
    tool = str(Path(build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    body = next(f for f in sass.split("Function : ") if "knn_partial" in f)
    counts = Counter(re.findall(
        r"\b(HMMA\.\S+|LDGSTS\S*|LDSM\S*|LD\.E\S*|LDS(?:\.\d+)?)\s", body))
    usage = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                           text=True, check=True).stdout
    regs = re.search(r"knn_partial.*?REG:(\d+)", usage, re.S)
    return (", ".join(f"{n} {op}" for op, n in sorted(counts.items()))
            + f"; {regs.group(1) if regs else '?'} registers")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bench_knn_versions: CUDA is not available", file=sys.stderr)
        return 2
    versions = dict(a.split("=", 1) for a in argv)
    if not versions:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    wrappers = {label: load_wrapper(Path(root), f"knn_version_{i}")
                for i, (label, root) in enumerate(versions.items())}
    with ThreadPoolExecutor(len(wrappers)) as pool:  # one nvcc each
        list(pool.map(lambda w: w.load_library(), wrappers.values()))
    record = {"card": card, "sass": {}, "checks": {}, "shapes": {}}
    for label, w in wrappers.items():
        record["sass"][label] = sass_summary(w)
        print(f"{label}: knn_partial SASS {record['sass'][label]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for key, (p, valid) in SHAPES.items():
        feats, bank, mask = cs.knn_inputs(gen, 3, 64, p, cs.HIDDEN, valid)
        ref_idx, ref_dist = wrappers[next(iter(wrappers))] \
            .cosine_knn_reference(feats, bank, mask, cs.K)
        for label, w in wrappers.items():
            idx, dist = w.cosine_knn(feats, bank, mask, cs.K)
            torch.cuda.synchronize()
            try:
                agrees = "near-tie swaps " + str(w.near_tie_swaps(
                    idx, dist, ref_idx, ref_dist, cs.KNN_TOL))
            except AssertionError as e:  # timed all the same, marked so
                agrees = f"DISAGREES with the plain version: {e}"
            print(f"{key} {label}: max_abs_err "
                  f"{cs.knn_err(dist, ref_dist)!r}, {agrees}", flush=True)
            record["checks"][f"{key} {label}"] = agrees
        windows = []
        order = list(wrappers)
        for seq in (order, order[::-1]):
            for label in seq:
                w = wrappers[label]
                passes, counts = {}, []
                before = cs.gpu_clocks()
                ms = cs.launch_ms(
                    lambda w=w: w.cosine_knn(feats, bank, mask, cs.K), ITERS,
                    cs.KNN_PASSES, passes, counts)
                after = cs.gpu_clocks()
                windows.append({"version": label, "ms": ms, **passes,
                                "clocks_before": before,
                                "clocks_after": after, "events": counts[0]})
                print(f"{key} {label}: {ms!r} ms, passes "
                      f"{json.dumps(passes)}; clocks, power, temperature "
                      f"{before} -> {after}; events {counts[0]}", flush=True)
        bound, by, flops, nbytes = cs.knn_bound(feats, mask, cs.K, card)
        record["shapes"][key] = {"bound_ms": bound, "bound_by": by,
                                 "flops": flops, "bytes": nbytes,
                                 "windows": windows}
        print(f"{key}: bound {bound!r} ms by {by}; on {card}", flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
