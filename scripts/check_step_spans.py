"""One traced run of a benchmark cell, as ``benchmark/run.py --trace 1``
makes it, then what its profiled stretches show of the train step's spans
(``egopack_torch/tracing.py``), and what a span costs on this host.

    python3 scripts/check_step_spans.py --workload mtl-step --seed 7 \
        --seconds 10 [--out chiprun_out/spans_mtl-step.json]

Run it from the root of the checkout to measure: that checkout's program
and benchmark are imported. It needs a CUDA card. It prints one JSON
object and writes it to ``--out``:

- ``stretches``: for each stretch, whether it recorded the host's
  operations, its device events, and every device event whose name starts
  with ``egopack.`` (a span echoed onto the card's timeline; there should be
  none);
- ``launches``: on each stretch that recorded the host's operations, the
  launch calls (``benchmark/harness/spans.py``) inside each phase, inside
  ``egopack.step``, the step's own (inside it, outside every phase),
  outside it and, of those, under ``bench.feed``; each phase's calls by
  name; beside the device's kernels, copies and fills;
- ``span_us``: the host cost of one span with no profiler and under a
  profiler that records the host and the card.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.getcwd())


def launch_report(ctx) -> list:
    from benchmark.harness import spans
    out = []
    for st in ctx.op_stretches():
        calls = spans.launches(st)
        step = spans.spans(st, spans.STEP)
        within = {p: spans.spans(st, p) for p in spans.PHASES}
        phases = {p: spans.inside(calls, iv) for p, iv in within.items()}
        in_step = spans.inside(calls, step)
        outside = [c for c in calls if spans.inside([c], step) == 0]
        named = [(n, s, e) for n, s, e in st.host
                 if n.startswith(spans.LAUNCH_PREFIXES)]
        by_phase = {p: dict(collections.Counter(
            n for n, s, e in named if spans.inside([(s, e)], iv)))
            for p, iv in within.items()}
        kinds = collections.Counter(
            "fills" if n.startswith("Memset") else
            "copies" if n.startswith("Memcpy") else "kernels"
            for n, _, _ in st.device)
        out.append({
            "steps": st.steps, "launch_calls": len(calls),
            "device_events": dict(kinds),
            "launch_names": dict(collections.Counter(n for n, _, _ in named)),
            "phase_launch_names": by_phase,
            "step_spans": len(step), "in_step": in_step,
            "phases": phases, "step_self": in_step - sum(phases.values()),
            "outside_step": len(outside),
            "outside_step_under_feed": spans.inside(
                outside, spans.spans(st, "bench.feed"))})
    return out


def span_cost_us(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from egopack_torch import tracing

    def loop(n):
        t = time.perf_counter()
        for _ in range(n):
            with tracing.span("egopack.cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    def empty(n):
        t = time.perf_counter()
        for _ in range(n):
            pass
        return (time.perf_counter() - t) / n * 1e6

    loop(1000)
    off, base = loop(n_off), empty(n_off)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = loop(n_on)
    tracing.reset()
    return {"off": off, "on": on, "empty_loop": base}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from benchmark.harness.cell import check_lines, run_cell
    from benchmark.harness.manifest import Manifest

    if not torch.cuda.is_available():
        print("check_step_spans.py: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    seen = {}
    read_metrics = Manifest.read_metrics

    def keep_context(self, name, ctx):
        seen["ctx"] = ctx
        return read_metrics(self, name, ctx)

    Manifest.read_metrics = keep_context

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    out = run_cell(Manifest(), args.workload, args.seed, args.seconds, True,
                   device, STARTED, log=log)
    for line in check_lines(out["checks"]):
        log(line)
    ctx = seen["ctx"]
    report = {
        "workload": args.workload, "seed": args.seed,
        "correct": out["correct"], "metrics": out["metrics"],
        "stretches": [{"host_ops": st.host_ops,
                       "device_events": len(st.device),
                       "egopack_device_events": sorted(
                           {n for n, _, _ in st.device
                            if n.startswith("egopack.")})}
                      for st in ctx.stretches],
        "launches": launch_report(ctx)}
    try:
        report["span_us"] = span_cost_us()
    except ImportError as e:  # a program without the spans
        report["span_us"] = f"not measured: {e}"
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
