"""``egopack_torch.profiling``: busy time is the union of the intervals, so
overlapping kernels count once and gaps not at all."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from egopack_torch import profiling

torch.set_num_threads(1)


def _event(start, end, device=DeviceType.CUDA):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                           device_type=device)


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
