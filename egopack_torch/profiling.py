"""Reading the card's work out of a ``torch.profiler`` trace.

Kernels can overlap on the card (several streams, or a launch that starts
before the previous kernel ends), so the time the card is busy is the length
of the union of their intervals, not the sum of their durations.
"""

from __future__ import annotations

from typing import List, Sequence

from torch.autograd import DeviceType


def device_events(prof) -> List:
    """The kernels, copies and fills that ``prof`` recorded on the card."""
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(events: Sequence) -> float:
    """Microseconds covered by the union of the events' time ranges."""
    total, start, end = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total if end is None else total + end - start
