"""``graph_replay_share``: the program's replayed steps over its steps, from
its span record; nothing where the program has no graphs or runs on the
CPU."""

import sys

import pytest

from benchmark.harness.manifest import Manifest
from benchmark.harness.trace import Context
from benchmark.harness.window import WindowResult

CARD = "NVIDIA H100 80GB HBM3"


def _read(card=CARD):
    ctx = Context({}, card, WindowResult(), 0, 0)
    return Manifest().metric_module("graph_replay_share").read(ctx)


@pytest.fixture
def record():
    from egopack_torch import tracing
    tracing.reset()
    yield tracing
    tracing.reset()


def _steps(tracing, steps, replays):
    for k in range(steps):
        with tracing.span("egopack.step"):
            if k >= steps - replays:
                with tracing.span("egopack.replay"):
                    pass


def test_replays_over_steps(record):
    _steps(record, 8, 6)
    assert _read() == 75.0


def test_no_replay_reads_zero(record):
    _steps(record, 3, 0)
    assert _read() == 0.0


def test_nothing_read_without_steps_or_off_the_card(record):
    assert _read() is None
    _steps(record, 4, 4)
    assert _read() == 100.0
    assert _read(card="cpu") is None


@pytest.mark.parametrize("module", ["egopack_torch.tracing",
                                    "egopack_torch.train.step_graph"])
def test_nothing_read_without_the_programs_graphs(record, monkeypatch,
                                                  module):
    """An older program has no step graphs, or no span record at all."""
    _steps(record, 4, 0)
    package, name = module.rsplit(".", 1)
    monkeypatch.setitem(sys.modules, module, None)
    monkeypatch.delattr(sys.modules[package], name, raising=False)
    assert _read() is None
