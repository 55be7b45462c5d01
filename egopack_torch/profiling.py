"""Reading the card's work out of a ``torch.profiler`` trace.

Kernels can overlap on the card (several streams, or a launch that starts
before the previous kernel ends), so the time the card is busy is the length
of the union of their intervals, not the sum of their durations.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

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


def mean_us(windows: Sequence[Sequence], names: Sequence[str]
            ) -> Dict[str, float]:
    """Mean duration in microseconds of each kernel in ``names`` (matched by
    substring) over the events of all ``windows``. Every event must match
    exactly one name, else this raises ``ValueError``. Events the profiler
    dropped from a window leave the means as they are, where a window's
    busy time would read short."""
    durations = {n: [] for n in names}
    for e in (e for events in windows for e in events):
        hit = [n for n in names if n in e.name]
        if len(hit) != 1:
            raise ValueError(f"{e.name!r} is none or several of {names}")
        durations[hit[0]].append(e.time_range.end - e.time_range.start)
    missing = [n for n, us in durations.items() if not us]
    if missing:
        raise ValueError(f"no events of {missing}")
    return {n: sum(us) / len(us) for n, us in durations.items()}
