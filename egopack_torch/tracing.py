"""Named host spans inside the train step, on the profiler's clock when a
``torch.profiler`` records, in a bounded host-clock record otherwise.

``with span("egopack.forward"): ...`` marks a phase of the program. Each
span knows its name, its start and end in host ns (``perf_counter_ns``) and
the span it opened inside (a per-thread stack). Where it goes depends on
whether a profiler records when it opens:

- recording: it also enters the profiler as a function-scope host op
  (``_RecordFunctionFast``), on the timeline of the profiler's device
  events, and stays out of the host-clock record, so profiled steps never
  mix into the medians. A ``record_function`` range would be a user
  annotation, which the profiler echoes onto the device's timeline;
- not recording: its duration joins the record, which keeps the newest
  ``KEEP`` spans of each name and counts every span and its seconds.

``summary()`` reads the record; ``reset()`` clears it. The spans reach a
file through the trace that ``profile_dir`` writes.
"""

from __future__ import annotations

import collections
import statistics
import threading
from time import perf_counter_ns
from typing import Dict

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

KEEP = 4096  # spans kept a name: a benchmark window's steps, several times

_local = threading.local()
_lock = threading.Lock()


class _Record:
    __slots__ = ("spans", "count", "total_ns")

    def __init__(self):
        self.spans = collections.deque(maxlen=KEEP)
        self.count = 0
        self.total_ns = 0


_records: Dict[str, _Record] = {}


class span:
    """A context manager around one phase; ``seconds`` holds its host time
    once it has closed, whether or not a profiler recorded it."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "_op")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].name if stack else None  # its name
        stack.append(self)
        self._op = None
        if _autograd_profiler._is_profiler_enabled:
            self._op = _RecordFunctionFast(self.name)
            self._op.__enter__()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = perf_counter_ns()
        _local.stack.pop()
        if self._op is not None:
            self._op.__exit__(*exc)
            return
        with _lock:
            rec = _records.get(self.name)
            if rec is None:
                rec = _records[self.name] = _Record()
            rec.spans.append(self)
            rec.count += 1
            rec.total_ns += self.end_ns - self.start_ns

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def summary() -> Dict[str, dict]:
    """For each name in the record: ``count`` and ``total_s`` over every
    span since the last ``reset()``, ``median_ms`` and ``p95_ms`` over the
    ``kept`` newest."""
    out = {}
    with _lock:
        items = [(n, r.count, r.total_ns, [s.end_ns - s.start_ns
                                           for s in r.spans])
                 for n, r in _records.items()]
    for name, count, total_ns, kept in items:
        ms = [d / 1e6 for d in kept]
        p95 = (statistics.quantiles(ms, n=20)[18] if len(ms) > 1 else ms[0])
        out[name] = {"count": count, "kept": len(ms),
                     "median_ms": statistics.median(ms), "p95_ms": p95,
                     "total_s": total_ns / 1e9}
    return out


def reset() -> None:
    with _lock:
        _records.clear()
