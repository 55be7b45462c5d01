"""``egopack_torch.profiling``: busy time is the union of the intervals, so
overlapping kernels count once and gaps not at all; a kernel's mean
duration does not move when the profiler drops some of its events."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from egopack_torch import profiling

torch.set_num_threads(1)


def _event(start, end, device=DeviceType.CUDA, name="kernel"):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, name=name)


@pytest.mark.parametrize("spans,busy", [
    ([], 0.0),
    ([(0, 2)], 2.0),
    ([(5, 6), (0, 2)], 3.0),            # a gap between them is not busy
    ([(0, 2), (1, 3)], 3.0),            # overlap counts once
    ([(0, 10), (2, 3), (4, 12)], 12.0),  # nested and chained
])
def test_busy_us(spans, busy):
    assert profiling.busy_us([_event(s, e) for s, e in spans]) == busy


def test_device_events_keeps_the_cards_events():
    cpu, card = _event(0, 1, DeviceType.CPU), _event(1, 2)
    prof = SimpleNamespace(events=lambda: [cpu, card])
    assert profiling.device_events(prof) == [card]


def test_mean_us_through_dropped_events():
    """Two windows of two calls, each launching a 3 µs and a 1 µs kernel;
    the second window lost one of its short kernels (the busy time of that
    window would read 7 µs where 8 were spent)."""
    calls = [_event(0, 3, name="ns::knn_partial(float const*)"),
             _event(3, 4, name="ns::knn_merge(float const*)"),
             _event(10, 13, name="ns::knn_partial(float const*)"),
             _event(13, 14, name="ns::knn_merge(float const*)")]
    means = profiling.mean_us([calls, calls[:3]], ("knn_partial",
                                                   "knn_merge"))
    assert means == {"knn_partial": 3.0, "knn_merge": 1.0}


@pytest.mark.parametrize("names", [("knn_partial",), ("knn", "knn_merge"),
                                   ("knn_partial", "knn_merge", "adam")])
def test_mean_us_raises_on_an_event_it_cannot_place(names):
    calls = [_event(0, 3, name="knn_partial"), _event(3, 4, name="knn_merge")]
    with pytest.raises(ValueError):
        profiling.mean_us([calls], names)
