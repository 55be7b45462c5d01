#!/usr/bin/env python3
"""Time every tiling of the split-TF32 GEMM kernel at the benchmark cells'
shapes on one card, and fit ``egopack_torch/ops/gemm.py``'s cost model to
the times.

    python3 scripts/sweep_gemm_tiles.py [--out <file.json>]

The shapes are ``tests/test_torch_port_gemm.py:CELL_SHAPES``, every product
of the three cells' steps. At each, every tile of ``gemm.TILES`` and every
split over K up to ``gemm.MAX_SPLITS`` that divides the k-steps runs through
``gemm.launch``, 20 calls a CUDA graph, three replays timed by CUDA events
after one untimed; ``torch.matmul`` in float32 (cuBLAS) and in TF32 are
timed alike, as yardsticks. One line a shape gives the plan's pick, the
fastest tiling and cuBLAS; then the least-squares fit of ``STEP_US`` and
``WAVE_US`` a tile and the shared ``REDUCE_US`` and ``REDUCE_US_A_MB``
(the model of ``gemm.cost_us``), its mean relative error, and the time
the plan's picks lose to the fastest tilings, summed over the shapes. The
last line is the JSON of every time, also written to ``--out`` where given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from egopack_torch.ops import gemm  # noqa: E402

REPS = 20


def cell_shapes():
    spec = importlib.util.spec_from_file_location(
        "gemm_tests", ROOT / "tests" / "test_torch_port_gemm.py")
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    return sorted({s for cell in tests.CELL_SHAPES.values() for s in cell})


def timed_ms(fn) -> float:
    """Device ms a call: ``REPS`` calls in a CUDA graph, replayed three
    times after one untimed replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS / 3


def operands(layout, batch, m, n, k, dev):
    gen = torch.Generator(device=dev).manual_seed(m * n + k)
    lead = (batch,) if batch > 1 else ()
    a = torch.randn(lead + ((k, m) if layout == "tn" else (m, k)),
                    device=dev, generator=gen)
    b = torch.randn(lead + ((n, k) if layout == "nt" else (k, n)),
                    device=dev, generator=gen)
    return a, b, torch.randn(n, device=dev, generator=gen)


def plans(batch, m, n, k):
    k_tiles = -(-k // gemm.BK)
    return [gemm.Plan(wg, cols, s, k_tiles // s) for wg, cols in gemm.TILES
            for s in range(1, min(gemm.MAX_SPLITS, k_tiles) + 1)
            if k_tiles % s == 0 and batch * s <= 65535]


def fit(rows):
    """Least squares of the microseconds on the model's terms: for each
    tile, waves x k-steps a split (``STEP_US``) and waves (``WAVE_US``);
    for every split product one reduction launch (``REDUCE_US``) and its
    megabytes of partial sums (``REDUCE_US_A_MB``)."""
    tiles = list(gemm.TILES)
    x, y = [], []
    for (layout, batch, m, n, k), p, us in rows:
        tile = (p.warpgroups, p.columns)
        waves = -(-gemm.blocks(batch, m, n, p)
                  // (gemm.SMS * gemm.BLOCKS_PER_SM[tile]))
        row = [0.0] * (2 * len(tiles) + 2)
        i = tiles.index(tile)
        row[2 * i], row[2 * i + 1] = waves * p.tiles_per_split, waves
        if p.splits > 1:
            row[-2] = 1.0
            row[-1] = 4 * batch * m * n * (2 * p.splits + 1) / 1e6
        x.append(row)
        y.append(us)
    coef, *_ = np.linalg.lstsq(np.array(x), np.array(y), rcond=None)
    pred = np.array(x) @ coef
    err = float(np.mean(np.abs(pred - np.array(y)) / np.array(y)))
    step = {t: round(float(coef[2 * i]), 3) for i, t in enumerate(tiles)}
    wave = {t: round(float(coef[2 * i + 1]), 3) for i, t in enumerate(tiles)}
    reduce_us, reduce_mb = (round(float(c), 3) for c in coef[-2:])
    return step, wave, reduce_us, reduce_mb, err


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gemm.load_library()
    out, rows = [], []
    lost = best_sum = 0.0
    for layout, batch, m, n, k in cell_shapes():
        a, b, bias = operands(layout, batch, m, n, k, dev)
        times = {}
        for p in plans(batch, m, n, k):
            times[p] = timed_ms(lambda: gemm.launch(a, b, layout, bias, p))
            rows.append(((layout, batch, m, n, k), p, times[p] * 1e3))
        cublas = timed_ms(
            lambda: gemm.tf32x3_gemm_reference(a, b, layout, bias))
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = timed_ms(
            lambda: gemm.tf32x3_gemm_reference(a, b, layout, bias))
        torch.backends.cuda.matmul.allow_tf32 = False
        pick = gemm.plan(batch, m, n, k)
        best = min(times, key=times.get)
        lost += times[pick] - times[best]
        best_sum += times[best]
        work = 2 * batch * m * n * k
        print(f"{layout} b{batch} {m}x{n}x{k}: plan {tuple(pick)} "
              f"{times[pick] * 1e3:.1f} us, best {tuple(best)} "
              f"{times[best] * 1e3:.1f} us "
              f"({work / times[best] / 1e9:.1f} TFLOP/s), cuBLAS float32 "
              f"{cublas * 1e3:.1f} us, TF32 {tf32 * 1e3:.1f} us", flush=True)
        out.append({"shape": [layout, batch, m, n, k],
                    "times": {",".join(map(str, p)): t
                              for p, t in times.items()},
                    "cublas": cublas, "tf32": tf32})
    step, wave, reduce_us, reduce_mb, err = fit(rows)
    print(f"fit: STEP_US {step}, WAVE_US {wave}, REDUCE_US {reduce_us}, "
          f"REDUCE_US_A_MB {reduce_mb}; mean relative error {err:.3f}")
    print(f"the plan's picks lose {lost * 1e3:.1f} us to the fastest "
          f"tilings over {len(out)} shapes ({best_sum * 1e3:.1f} us)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
