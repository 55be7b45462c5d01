"""The metrics that read the program's spans, on hand-built stretches: the
launch calls a phase makes a step (``harness/spans.py``, which the
optimizer's metric reads), and the host ms of a span from the program's
record; each reads nothing where the program has no spans."""

import sys

import pytest

from benchmark.harness import spans
from benchmark.harness.manifest import Manifest
from benchmark.harness.trace import Context
from benchmark.harness.window import Stretch, WindowResult

SPANS = (spans.STEP,) + spans.PHASES
HOST_MS = {"step_span_host_ms": "egopack.step",
           "optimizer_host_ms": "egopack.optimizer"}
LAUNCHES = {"optimizer_launches_per_step": "egopack.optimizer"}
CARD = "NVIDIA H100 80GB HBM3"


def _ctx(host, steps, host_ops=True, card=CARD):
    stretch = Stretch(steps, [], host, 0, host_ops)
    return Context({}, card, WindowResult(stretches=[stretch]), 0, 0)


def _read(name, ctx):
    return Manifest().metric_module(name).read(ctx)


def _two_steps():
    """Two steps: each a step span holding forward, backward, norms and
    optimizer, the launches placed inside, outside and across them."""
    host = [("bench.feed", 0, 5), ("cudaMemcpyAsync", 1, 2)]
    for t in (10, 110):
        host += [("egopack.step", t, t + 90),
                 ("egopack.forward", t + 1, t + 30),
                 ("egopack.backward", t + 31, t + 60),
                 ("egopack.norms", t + 61, t + 80),
                 ("egopack.optimizer", t + 81, t + 89),
                 ("aten::mm", t + 2, t + 6),
                 ("cudaLaunchKernel", t + 3, t + 4),     # forward
                 ("cudaLaunchKernel", t + 5, t + 6),     # forward
                 ("cuLaunchKernel", t + 32, t + 33),     # backward
                 ("cudaMemsetAsync", t + 40, t + 41),    # backward
                 ("cudaLaunchKernel", t + 59, t + 62),   # across: the step's
                 ("cudaLaunchKernel", t + 62, t + 63),   # norms
                 ("cudaLaunchKernel", t + 63, t + 64),   # norms
                 ("cudaLaunchKernel", t + 65, t + 66),   # norms
                 ("cudaLaunchKernel", t + 82, t + 83),   # optimizer
                 ("cudaEventRecord", t + 84, t + 85),    # queues no work
                 ("cudaLaunchKernel", t + 89.5, t + 89.8)]  # the step's
    return host


def test_launches_inside_outside_and_across_spans():
    ctx = _ctx(_two_steps(), steps=2)
    got = {n: spans.launches_per_step(ctx, n) for n in SPANS[1:]}
    assert got == {"egopack.forward": 2.0, "egopack.backward": 2.0,
                   "egopack.norms": 3.0, "egopack.optimizer": 1.0}
    assert _read("optimizer_launches_per_step", ctx) == 1.0
    st = ctx.op_stretches()[0]
    calls = spans.launches(st)
    in_step = spans.inside(calls, spans.spans(st, "egopack.step"))
    assert len(calls) == 2 * 10 + 1 and in_step == 2 * 10
    assert in_step - sum(got.values()) * 2 == 2 * 2  # the step's own


def test_the_span_check_script_reads_the_harness():
    """``scripts/check_step_spans.py`` reports launches by phase from the
    names this module gives (``STEP``, ``PHASES``, ``LAUNCH_PREFIXES``):
    its report on the hand-built steps agrees with the readers here."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[2] / "scripts" / \
        "check_step_spans.py"
    spec = importlib.util.spec_from_file_location("check_step_spans", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    (got,) = script.launch_report(_ctx(_two_steps(), steps=2))
    assert got["phases"] == {"egopack.forward": 4, "egopack.backward": 4,
                             "egopack.norms": 6, "egopack.optimizer": 2}
    assert (got["in_step"], got["step_self"]) == (20, 4)
    assert (got["outside_step"], got["outside_step_under_feed"]) == (1, 1)


def test_steps_divide_and_card_only_stretches_are_not_read():
    host = _two_steps()
    assert spans.launches_per_step(_ctx(host, steps=4),
                                   "egopack.norms") == 1.5
    assert spans.launches_per_step(_ctx(host, steps=2, host_ops=False),
                                   "egopack.norms") is None


def test_no_launch_calls_no_reading():
    """The CPU's trace has the spans but no runtime calls."""
    host = [e for e in _two_steps() if e[0].startswith(("egopack.", "aten"))]
    for span in SPANS:
        assert spans.launches_per_step(_ctx(host, steps=2), span) is None


@pytest.mark.parametrize("name", sorted(HOST_MS) + sorted(LAUNCHES))
def test_nothing_read_without_the_programs_spans(name, monkeypatch):
    """A program without ``egopack_torch/tracing.py`` has no record and no
    span in its trace."""
    import egopack_torch
    monkeypatch.setitem(sys.modules, "egopack_torch.tracing", None)
    monkeypatch.delattr(egopack_torch, "tracing", raising=False)
    parent = [e for e in _two_steps() if not e[0].startswith("egopack.")]
    assert _read(name, _ctx(parent, steps=2)) is None


def test_host_ms_reads_the_programs_record():
    from egopack_torch import tracing
    tracing.reset()
    try:
        for _ in range(3):
            with tracing.span("egopack.step"):
                with tracing.span("egopack.forward"):
                    pass
        ctx = _ctx([], steps=1)
        for name, span in HOST_MS.items():
            got = _read(name, ctx)
            row = tracing.summary().get(span)
            assert got == (row["median_ms"] if row else None), name
        assert _read("step_span_host_ms", ctx) > 0
        assert _read("optimizer_host_ms", ctx) is None
    finally:
        tracing.reset()


def test_host_ms_reads_nothing_off_the_card():
    """On the CPU a span times the work, not the host's dispatch: the
    record is there, and the metrics leave it alone."""
    from egopack_torch import tracing
    tracing.reset()
    try:
        with tracing.span("egopack.step"):
            pass
        assert "egopack.step" in tracing.summary()
        ctx = _ctx([], steps=1, card="cpu")
        for name in HOST_MS:
            assert _read(name, ctx) is None, name
    finally:
        tracing.reset()


def test_the_benchmarks_step_records_the_five_spans():
    """The step the benchmark times is the program's: a traced run on the
    CPU leaves each of the five spans in the program's record, once a
    step at least, the norms included (the cell logs them every step)."""
    from benchmark.tests.tiny import run_tiny
    from egopack_torch import tracing
    tracing.reset()
    try:
        out = run_tiny("novel-oscc-step", traced=True, seconds=0.2)
        assert out["correct"]
        got = tracing.summary()
        steps = got["egopack.step"]["count"]
        assert steps >= 1
        for span in SPANS:
            assert got[span]["count"] == steps, span
            assert got[span]["median_ms"] > 0, span
    finally:
        tracing.reset()
