"""Reading the traced stretches of a window: what the per-layer metrics
and the ``breakdown`` are made of."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import counts

NOT_KERNELS = ("Memcpy", "Memset")
# the benchmark's own ranges (``record_function``), which the profiler also
# lists on the device's timeline
RANGES = "bench."


@dataclass
class Context:
    """What a per-layer metric's ``read(ctx)`` may look at."""
    cfg: dict
    card: str
    window: object          # harness.window.WindowResult
    step_flops: int
    trainable_elements: int

    @property
    def stretches(self):
        return self.window.stretches

    def device_stretches(self):
        """The stretches that recorded the card's activity alone: the
        card's busy and idle time as in the window."""
        return [s for s in self.stretches if not s.host_ops]

    def op_stretches(self):
        """The stretches that also recorded the host's operations."""
        return [s for s in self.stretches if s.host_ops]

    def traced_steps(self, stretches=None) -> int:
        return sum(s.steps for s in (self.stretches if stretches is None
                                     else stretches))

    def kernels(self, part: str) -> List[Tuple[str, float, float]]:
        """Device events whose name holds ``part``, over every stretch."""
        return [e for s in self.stretches for e in s.device if part in e[0]]


def busy_and_span_us(stretch) -> Tuple[float, float]:
    """The union of the stretch's device intervals, and the span from its
    first device event's start to its last one's end."""
    spans = [(s, e) for _, s, e in stretch.device]
    if not spans:
        return 0.0, 0.0
    return (counts.union_us(spans),
            max(e for _, e in spans) - min(s for s, _ in spans))


def device_totals(stretches) -> Tuple[float, float]:
    """Busy and span seconds summed over the stretches."""
    busy = span = 0.0
    for st in stretches:
        b, s = busy_and_span_us(st)
        busy += b
        span += s
    return busy / 1e6, span / 1e6


def device_ms_per_step(stretches) -> Optional[float]:
    """The card's busy milliseconds a step over the stretches, or None
    where they recorded no device event."""
    busy, _ = device_totals(stretches)
    steps = sum(s.steps for s in stretches)
    return busy * 1e3 / steps if busy and steps else None


def breakdown(stretches, top: int = 10) -> dict:
    """The device operations that took most time over every stretch, and
    the longest idle gaps of the card in the stretches that recorded the
    host's operations (which those records lengthen), each named by what
    the host was doing at the gap's middle: the benchmark's range and the
    innermost host operation."""
    by_name = defaultdict(float)
    gaps = []
    for st in stretches:
        for name, s, e in st.device:
            by_name[name[:120]] += (e - s) / 1e6
        if not st.host_ops:
            continue
        merged = []
        for s, e in sorted((s, e) for _, s, e in st.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            gaps.append((s1 - e0, e0, s1, st))
    gaps.sort(key=lambda g: -g[0])
    idle = []
    for length, e0, s1, st in gaps[:top]:
        mid = (e0 + s1) / 2
        around = [(e - s, n) for n, s, e in st.host if s <= mid <= e]
        bench = [n for _, n in around if n.startswith(RANGES)]
        ops = [a for a in around if not a[1].startswith(RANGES)]
        inner = min(ops)[1] if ops else "Python"
        label = f"{bench[0] if bench else 'outside'} > {inner}"
        idle.append([label[:120], length / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
