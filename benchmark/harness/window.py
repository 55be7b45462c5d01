"""The measured window: optimizer steps back to back for ``seconds`` on
the host clock, ended by ``torch.cuda.synchronize()``.

Each step's time is the gap between CUDA events recorded on the stream at
consecutive step boundaries, with no synchronize inside the window, so a
stall the card waits through lands in the step after it. The host time of
each step call, and of each call for the next batch group (the wait for
data), is summed apart.

With tracing on, short stretches of ``STRETCH_STEPS`` steps follow the
window under ``torch.profiler``, each beginning on an idle card, after one
untimed profile that starts the profiler up. The first ``DEVICE_STRETCHES``
record the card's activity alone, which adds little to the host's work, so
the card's busy and idle time read as in the window; the last also records
the host's operations, for the launch calls inside the program's spans and
for naming what the host did while the card idled. An untraced run that reports
the card's busy time takes the card-only stretches alone. A stretch whose
count of Adam kernels differs from its steps lost device events, and
another is taken in its place.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .trace import RANGES

DEVICE_STRETCHES = 2
STRETCH_STEPS = 10
MAX_STRETCH_TRIES = 8
ADAM_KERNEL = "adam_kernel"


@dataclass
class Stretch:
    steps: int
    device: list        # device events: (name, start_us, end_us)
    host: list          # CPU events: (name, start_us, end_us)
    knn_calls: int
    host_ops: bool      # the host's operations recorded too


@dataclass
class WindowResult:
    steps: int = 0
    clips: int = 0
    seconds: float = 0.0
    host_s: float = 0.0      # summed over the window's steps
    data_s: float = 0.0      # the feed's next(), summed over the window
    host_steps: int = 0
    step_ms: List[float] = field(default_factory=list)
    logs: list = field(default_factory=list)
    stretches: List[Stretch] = field(default_factory=list)
    dropped: List[str] = field(default_factory=list)

    def p95_ms(self) -> float:
        if len(self.step_ms) < 2:
            return self.step_ms[0]
        return statistics.quantiles(self.step_ms, n=20)[18]


def _read(prof, steps: int, knn_calls: int, host_ops: bool) -> Stretch:
    dev, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type != DeviceType.CUDA:
            host.append(span)
        elif not e.name.startswith(RANGES):  # not the ranges' device echo
            dev.append(span)
    return Stretch(steps, dev, host, knn_calls, host_ops)


class _HostEvent:
    """A host-clock stand-in for ``torch.cuda.Event`` where a test drives
    the window on the CPU."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


def run(step: Callable, feed, seconds: float, trace: bool,
        device: torch.device,
        knn_launches: Optional[Callable[[], int]] = None,
        busy: bool = False) -> WindowResult:
    """``step(batches) -> logs``; ``feed.next() -> (batches, clips)``.
    ``trace`` takes every stretch after the window, ``busy`` the card-only
    ones."""
    cuda = device.type == "cuda"

    def event():
        return torch.cuda.Event(enable_timing=True) if cuda else _HostEvent()

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    out = WindowResult()
    events = []
    start_ev = event()
    sync()
    t0 = time.perf_counter()
    start_ev.record()
    while time.perf_counter() - t0 < seconds:
        td = time.perf_counter()
        batches, clips = feed.next()
        th = time.perf_counter()
        out.data_s += th - td
        out.logs.append(step(batches))
        out.host_s += time.perf_counter() - th
        ev = event()
        ev.record()
        events.append(ev)
        out.steps += 1
        out.clips += clips
    sync()
    out.seconds = time.perf_counter() - t0
    out.host_steps = out.steps
    prev = start_ev
    for ev in events:
        out.step_ms.append(prev.elapsed_time(ev))
        prev = ev
    if trace or busy:
        _stretches(out, step, feed, cuda, sync, knn_launches, host_ops=trace)
    return out


def _stretches(out: WindowResult, step: Callable, feed, cuda: bool,
               sync: Callable, knn_launches, host_ops: bool) -> None:
    device_only = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    both = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=both):  # starts the profiler up, untimed
        out.logs.append(step(feed.next()[0]))
        sync()
    plan = [device_only] * DEVICE_STRETCHES + ([both] if host_ops else [])
    tries = 0
    while plan and tries < MAX_STRETCH_TRIES:
        tries += 1
        activities = plan[0]
        sync()
        knn0 = knn_launches() if knn_launches else 0
        with profile(activities=activities) as prof:
            for _ in range(STRETCH_STEPS):
                with record_function("bench.feed"):
                    batches, _ = feed.next()
                with record_function("bench.step"):
                    out.logs.append(step(batches))
            sync()
        knn = (knn_launches() - knn0) if knn_launches else 0
        s = _read(prof, STRETCH_STEPS, knn, activities is both)
        adam = sum(1 for n, _, _ in s.device if ADAM_KERNEL in n)
        if adam == STRETCH_STEPS or not cuda:
            out.stretches.append(s)
            plan.pop(0)
        else:
            out.dropped.append(f"stretch {tries}: {adam} Adam kernels in "
                               f"{STRETCH_STEPS} steps, {len(s.device)} "
                               f"device events")
