#!/usr/bin/env python3
"""Where the time of the port's train steps goes, on one NVIDIA card.

    python3 scripts/profile_torch_step.py [--phase 1|2] [--steps 10] [--top 12]

Builds a full-width step of ``egopack_torch``: phase 1, the AR+LTA+PNR step
(batch 16 per task, feat 1536, hidden 1024, fused Adam, dropout 0.5;
``entry.build_mtl_step``), or phase 2, the novel-OSCC EgoPack step (batch 16,
seeded random banks of 2048 rows with 1900 valid, GraphONE depth 3 k=8, the
kNN kernel, fused Adam; ``entry.build_egopack_step``). It takes 3 warm-up
steps, then:

- times ``--steps`` steps with CUDA events, profiler off (ms/step);
- profiles as many steps with ``torch.profiler`` (CPU and CUDA activities)
  and reads the device's kernels from it: busy time per step (the union of
  kernel intervals), the device's idle share of the profiled window, kernels
  per step, and the kernels that take the most device time.

Prints the card's name and power limit, then one JSON line. Needs a card; it
does not run on the CPU.
"""

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from egopack_torch.entry import (build_egopack_step,  # noqa: E402
                                 build_mtl_step)
from egopack_torch.ops import fused_adam as tfa  # noqa: E402
from egopack_torch.ops import knn_topk as tkt  # noqa: E402
from egopack_torch.profiling import busy_us, device_events  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", type=int, choices=(1, 2), default=1)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    mtl = (build_mtl_step(impl="fused") if args.phase == 1
           else build_egopack_step())
    for _ in range(3):
        mtl()
    torch.cuda.synchronize()

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.steps):
        mtl()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.steps

    launches0 = tfa.fused_adam.launches
    knn0 = tkt.cosine_knn.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            mtl()
        torch.cuda.synchronize()
    adam_launches = tfa.fused_adam.launches - launches0
    knn_launches = tkt.cosine_knn.launches - knn0
    kernels = device_events(prof)
    if not kernels:
        print("profile_torch_step: the profiler recorded no device events",
              file=sys.stderr)
        return 1
    window_us = (max(e.time_range.end for e in kernels)
                 - min(e.time_range.start for e in kernels))
    busy = busy_us(kernels)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    print(card, flush=True)
    print(json.dumps({
        "card": card, "phase": args.phase, "steps": args.steps,
        "ms_per_step": step_ms,
        "device_busy_ms_per_step": busy / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy / window_us,
        "kernels_per_step": len(kernels) / args.steps,
        "fused_adam_launches_per_step": adam_launches / args.steps,
        "cosine_knn_launches_per_step": knn_launches / args.steps,
        "top_kernels": [{"name": n[:120], "ms_per_step": t / 1e3 / args.steps,
                         "share_of_busy": t / busy,
                         "calls_per_step": c / args.steps}
                        for n, (t, c) in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
