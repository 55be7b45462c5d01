"""The port's spans (``egopack_torch/tracing.py``): nesting, the bounded
host-clock record, the profiler's timeline, and the spans the train steps
open, on the CPU."""

import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from egopack_torch import tracing
from egopack_torch.entry import build_egopack_step, build_mtl_step

torch.set_num_threads(1)

STEP_SPANS = ("egopack.step", "egopack.forward", "egopack.backward",
              "egopack.norms", "egopack.optimizer")


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.reset()
    yield
    tracing.reset()


def counts():
    return {n: r["count"] for n, r in tracing.summary().items()}


def test_spans_nest_and_know_their_parent():
    with tracing.span("a") as a:
        with tracing.span("b") as b:
            with tracing.span("c") as c:
                pass
        with tracing.span("b") as b2:
            pass
    assert (a.parent, b.parent, c.parent, b2.parent) == (None, "a", "b", "a")
    assert (a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
            <= b2.start_ns <= b2.end_ns <= a.end_ns)
    assert counts() == {"a": 1, "b": 2, "c": 1}
    total = tracing.summary()["b"]["total_s"]
    assert total == pytest.approx(b.seconds + b2.seconds)
    # each thread keeps its own stack
    seen = []

    def other():
        with tracing.span("d") as d:
            seen.append(d.parent)

    with tracing.span("a"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [None]
    tracing.reset()
    assert tracing.summary() == {}


def test_record_keeps_the_newest_spans_of_a_name():
    n = tracing.KEEP + 10
    for _ in range(n):
        with tracing.span("x"):
            pass
    row = tracing.summary()["x"]
    assert (row["count"], row["kept"]) == (n, tracing.KEEP)
    assert 0 < row["median_ms"] <= row["p95_ms"]
    assert row["total_s"] >= row["median_ms"] / 1e3


def test_profiled_spans_enter_the_profiler_and_not_the_record():
    with tracing.span("egopack.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("egopack.outer") as outer:
            with tracing.span("egopack.inner"):
                torch.ones(4) + 1
    host = {e.name: e for e in prof.events()
            if e.device_type == DeviceType.CPU}
    assert {"egopack.outer", "egopack.inner"} <= set(host)
    o, i = host["egopack.outer"].time_range, host["egopack.inner"].time_range
    assert o.start <= i.start <= i.end <= o.end
    assert "aten::add" in host
    assert outer.seconds > 0
    assert counts() == {"egopack.before": 1}


def _phase1(log_norms=True, spc=1):
    return build_mtl_step(2, 16, 32, log_norms=log_norms, steps_per_call=spc,
                          device="cpu")


def _phase2(log_norms=True, spc=1):
    return build_egopack_step(2, 16, 32, p_pad=128, fill=100,
                              log_norms=log_norms, steps_per_call=spc,
                              device="cpu")


@pytest.mark.parametrize("build", [_phase1, _phase2], ids=["phase1", "phase2"])
@pytest.mark.parametrize("log_norms", [True, False])
def test_a_step_records_each_phase_once(build, log_norms):
    step = build(log_norms)
    tracing.reset()
    step()
    want = {n: 1 for n in STEP_SPANS if log_norms or n != "egopack.norms"}
    assert counts() == want


@pytest.mark.parametrize("build", [_phase1, _phase2], ids=["phase1", "phase2"])
def test_a_multi_step_records_each_step(build):
    step = build(spc=4)
    tracing.reset()
    step()
    assert counts() == {n: 4 for n in STEP_SPANS}
