"""Reading the program's spans (``egopack_torch/tracing.py``): the host
milliseconds of a phase from the program's host-clock record, and the
launch calls a phase makes from the stretches that recorded the host's
operations.

A program without the spans (an older commit), or a run on the CPU, gives
nothing to read: every reader here returns None, and raises nothing. On
the CPU the trace holds no CUDA runtime calls, and a span's host time is
the work itself rather than its dispatch to a card."""

from __future__ import annotations

import bisect
from typing import Optional

# the train step's span and its four phases, siblings inside it
STEP = "egopack.step"
PHASES = ("egopack.forward", "egopack.backward", "egopack.norms",
          "egopack.optimizer")
# CUDA runtime and driver calls that queue work on the card: kernel
# launches, copies and fills
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                   "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpy",
                   "cuMemcpy", "cudaMemset", "cuMemset")


def host_ms(ctx, name: str) -> Optional[float]:
    """The median host ms of span ``name`` over the program's unprofiled
    calls in this process; None off a card, where the span times the
    computation and not the host's share of the step."""
    if ctx.card == "cpu":
        return None
    try:
        from egopack_torch import tracing
    except ImportError:
        return None
    row = tracing.summary().get(name)
    return row["median_ms"] if row else None


def launches(stretch) -> list:
    """The stretch's launch calls: ``(start_us, end_us)``, by start."""
    return sorted((s, e) for n, s, e in stretch.host
                  if n.startswith(LAUNCH_PREFIXES))


def spans(stretch, name: str) -> list:
    """The stretch's spans ``name``: ``(start_us, end_us)``, by start."""
    return sorted((s, e) for n, s, e in stretch.host if n == name)


def inside(calls: list, intervals: list) -> int:
    """How many of ``calls`` lie wholly inside one of ``intervals``, which
    do not overlap one another; both by start. By time, not by thread:
    autograd launches the backward's kernels from its own thread while the
    step's thread waits inside the span."""
    starts = [s for s, _ in intervals]
    n = 0
    for s, e in calls:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= intervals[i][1]:
            n += 1
    return n


def launches_per_step(ctx, name: str) -> Optional[float]:
    """Launch calls inside spans ``name`` a step, over the stretches that
    recorded the host's operations; None where those hold no such span or
    no launch call."""
    stretches = ctx.op_stretches()
    found = calls = n = 0
    for st in stretches:
        intervals = spans(st, name)
        calls_here = launches(st)
        found += len(intervals)
        calls += len(calls_here)
        n += inside(calls_here, intervals)
    steps = ctx.traced_steps(stretches)
    if not (found and calls and steps):
        return None
    return n / steps
