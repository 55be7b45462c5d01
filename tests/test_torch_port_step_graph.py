"""The train step's CUDA graphs (``egopack_torch/train/step_graph.py``).

On the CPU: the policy, driven with a stand-in for the graph that runs the
captured function again at each replay (``_stub_capture``): which calls stay
eager, the count per signature, the caps, the launch counters, fresh logs,
and the system's phase-1 and phase-2 steps replayed against eager ones. On
the card (``cuda``): replayed steps against eager ones, bit for bit.

This file imports only torch and the port, so it runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_port_step_graph.py``.
"""

import gc

import pytest
import torch

from egopack_torch import entry, flops, tracing
from egopack_torch.device import make_generator
from egopack_torch.models import graphone as graphone_module
from egopack_torch.models.graphone import GraphONE
from egopack_torch.ops import fused_adam as tfa
from egopack_torch.ops import gemm
from egopack_torch.ops import knn_topk as tkt
from egopack_torch.ops import sum_squares as tss
from egopack_torch.parallel.mesh import Mesh
from egopack_torch.train import optim as topt
from egopack_torch.train import step_graph
from egopack_torch.train.step_graph import StepGraphs
from egopack_torch.train.system import CKPT_KEYS

FEAT, HIDDEN, BATCH = 16, 32, 2
ACTIVE = ("ar", "lta", "pnr")
STEPS = step_graph.EAGER_CALLS + 8


class _StubGraph:
    """A graph's stand-in: each replay runs the captured function again on
    the graph's input buffers and copies its outputs into the buffers the
    capture returned. A replay runs no Python, so the launch counters are
    put back after it."""

    def __init__(self, step, out):
        self.step, self.out = step, out

    def replay(self):
        counts = [c.launches for c in step_graph.COUNTERS]
        grads, packed, _ = self.step()
        for c, n in zip(step_graph.COUNTERS, counts):
            c.launches = n
        for name, g in grads.items():
            self.out[0][name].copy_(g)
        if packed is not None:
            self.out[1].copy_(packed)


def _stub_capture(step, generators):
    """A capture draws nothing from the generators: the stand-in runs
    ``step`` once for its output buffers and puts their states back."""
    states = [g.get_state() for g in generators]
    out = step()
    for g, s in zip(generators, states):
        g.set_state(s)
    return _StubGraph(step, out), out


class _NullGraph:
    def replay(self):
        pass


def _null_capture(step, generators):
    """A stand-in that keeps nothing of the step alive (``_stub_capture``
    keeps the step, its inputs with it); its replays compute nothing."""
    return _NullGraph(), step()


@pytest.fixture
def stub_on_cpu(monkeypatch):
    """Graphs on the CPU: the policy takes CPU tensors, the stand-in
    captures."""
    monkeypatch.setattr(StepGraphs, "DEVICE_TYPE", "cpu")
    monkeypatch.setattr(step_graph, "capture", _stub_capture)


def _no_capture(step, generators):
    raise AssertionError("the step must stay eager here")


class _Counter:
    launches = 0


def _toy(seen):
    """``compute(args, flag)`` of a toy step over ``args[0]["x"]``: one
    gradient, two logs, a launch counted; ``seen`` gets each call's x."""

    def compute(args, flag):
        x = args[0]["x"]
        seen.append(x)
        _Counter.launches += 2
        return ({"w": x.sum(0) * 2.0},
                {"loss": x.sum() * (2.0 if flag else 1.0), "mean": x.mean()})

    return compute


def _span_count(name):
    row = tracing.summary().get(name)
    return row["count"] if row else 0


# ---------------- the policy, on the CPU ----------------

def test_eager_calls_then_capture_then_replays(stub_on_cpu, monkeypatch):
    monkeypatch.setattr(step_graph, "COUNTERS", (_Counter,))
    _Counter.launches = 0
    tracing.reset()
    seen = []
    graphs = StepGraphs(_toy(seen), lambda: 1)
    gen = torch.Generator()
    xs = [torch.full((3, 2), float(i)) for i in range(7)]
    outs = [graphs(({"x": x}, gen), True) for x in xs]
    eager = step_graph.EAGER_CALLS
    # the first calls run on the caller's tensors; the capture and the
    # stand-in's replays on the graph's own copies
    assert all(seen[i] is xs[i] for i in range(eager))
    assert all(s is not x for s in seen[eager:] for x in xs)
    for x, (grads, logs) in zip(xs, outs):
        assert torch.equal(logs["loss"], x.sum() * 2.0)
        assert torch.equal(logs["mean"], x.mean())
    assert torch.equal(outs[-1][0]["w"], xs[-1].sum(0) * 2.0)
    assert _span_count("egopack.replay") == len(xs) - eager
    # the capture adds nothing; each call, eager or replayed, adds its 2
    assert _Counter.launches == 2 * len(xs)
    tracing.reset()


def test_each_call_returns_fresh_logs(stub_on_cpu):
    graphs = StepGraphs(_toy([]), lambda: 1)
    gen = torch.Generator()
    xs = [torch.full((3, 2), float(i)) for i in range(6)]
    logs = [graphs(({"x": x}, gen), False)[1] for x in xs]
    a, b = logs[-2], logs[-1]  # both replayed
    assert a["loss"].data_ptr() != b["loss"].data_ptr()
    assert a["loss"].item() == xs[-2].sum().item()
    assert b["loss"].item() == xs[-1].sum().item()
    assert a["loss"].dtype == torch.float32 and a["loss"].shape == ()


class _Bank:
    """An object the signature keys by identity, as the prototype banks."""


def test_signature_keys(stub_on_cpu):
    """Shapes, flags, numbers by value and objects by identity make
    signatures of their own, a generator by its device alone; a leaf that
    takes no weak reference keeps its calls eager."""
    graphs = StepGraphs(_toy([]), lambda: 1)
    gen, bank, other = torch.Generator(), _Bank(), _Bank()
    x, y = torch.ones(3, 2), torch.ones(4, 2)
    calls = [({"x": x}, gen), ({"x": y}, gen), ({"x": x}, bank),
             ({"x": x}, other), ({"x": x}, gen, 0.5), ({"x": x}, gen, 0.25)]
    for args in calls:
        for flag in (True, False):
            graphs(args, flag)
    assert len(graphs.entries) == 2 * len(calls)
    assert all(e.calls == 1 for e in graphs.entries.values())
    graphs(({"x": x}, torch.Generator()), True)  # another generator
    assert len(graphs.entries) == 2 * len(calls)
    graphs(({"x": x}, [1, 2]), True)  # a list is structure, not a leaf
    graphs(({"x": x}, {1: bank}), True)
    before = len(graphs.entries)
    graphs(({"x": x}, object()), True)  # it takes no weak reference
    assert len(graphs.entries) == before


def test_cap_on_captured_signatures(stub_on_cpu):
    captured = StepGraphs.captures
    seen = []
    graphs = StepGraphs(_toy(seen), lambda: 1)
    gen = torch.Generator()
    shapes = [(n, 2) for n in range(1, step_graph.MAX_GRAPHS + 2)]
    for shape in shapes:
        for _ in range(step_graph.EAGER_CALLS + 3):
            graphs(({"x": torch.ones(shape)}, gen), True)
    assert StepGraphs.captures - captured == step_graph.MAX_GRAPHS
    last = [e for e in graphs.entries.values() if e.graph is None]
    assert len(last) == 1 and last[0].calls == step_graph.EAGER_CALLS + 3
    # past the cap, every call of the last signature ran eagerly
    assert sum(1 for s in seen if tuple(s.shape) == shapes[-1]) == \
        step_graph.EAGER_CALLS + 3


def test_a_gone_object_frees_its_graph(stub_on_cpu, monkeypatch):
    """The graph of a gone bank leaves room for the next."""
    monkeypatch.setattr(step_graph, "capture", _null_capture)
    graphs = StepGraphs(_toy([]), lambda: 1)
    x = torch.ones(3, 2)
    banks = [_Bank() for _ in range(step_graph.MAX_GRAPHS)]
    for b in banks:
        for _ in range(step_graph.EAGER_CALLS + 1):
            graphs(({"x": x}, b), True)
    assert sum(e.graph is not None for e in graphs.entries.values()) == \
        step_graph.MAX_GRAPHS
    new = _Bank()
    for _ in range(step_graph.EAGER_CALLS + 1):
        graphs(({"x": x}, new), True)
    assert graphs.entries[next(reversed(graphs.entries))].graph is None
    del banks[0]
    gc.collect()
    graphs(({"x": x}, new), True)  # captures now
    assert len(graphs.entries) == step_graph.MAX_GRAPHS
    assert all(e.graph is not None for e in graphs.entries.values())


def test_signatures_counted_are_capped(stub_on_cpu):
    seen = []
    graphs = StepGraphs(_toy(seen), lambda: 1)
    gen = torch.Generator()
    for n in range(1, step_graph.MAX_SIGNATURES + 4):
        graphs(({"x": torch.ones(n, 2)}, gen), True)
    assert len(graphs.entries) == step_graph.MAX_SIGNATURES
    assert len(seen) == step_graph.MAX_SIGNATURES + 3


def test_cpu_tensors_never_capture(monkeypatch):
    monkeypatch.setattr(step_graph, "capture", _no_capture)
    seen = []
    graphs = StepGraphs(_toy(seen), lambda: 1)
    gen = torch.Generator()
    for _ in range(step_graph.EAGER_CALLS + 3):
        graphs(({"x": torch.ones(3, 2)}, gen), True)
    assert graphs.entries == {} and len(seen) == step_graph.EAGER_CALLS + 3


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_a_grid_of_several_ranks_never_captures(stub_on_cpu, monkeypatch,
                                                data, model):
    """The system's step on a grid of two ranks stays eager; on one rank
    the same step captures (the control)."""
    for grid, captures in (((data, model), 0), ((1, 1), 1)):
        system, _, call, draw = _build(1, torch.device("cpu"))
        gen = make_generator(1, torch.device("cpu"))
        # only the grid's size: its axes stay those of one process
        system.mesh = Mesh(*grid)
        monkeypatch.setattr(step_graph, "capture",
                            _no_capture if captures == 0 else _stub_capture)
        before = StepGraphs.captures
        for k in range(step_graph.EAGER_CALLS + 2):
            call(draw(k), gen)
        assert StepGraphs.captures - before == captures


# ---------------- the system's steps ----------------

def _build(phase, device):
    """A fresh step at a small width: ``(system, opt_state, call(batches,
    dropout generator), draw(k, batch))``, ``draw`` giving step k's batch
    group. Phase 1:
    ``[ar, lta, pnr]`` with the per-layer norms, pooling dropout 0.5 and
    LTA labels drawn anew each step. Phase 2: novel OSCC with GraphONE (k 8,
    depth 3, residual) over banks of 256 rows, 200 valid, and the backbone
    in train mode (its pooling dropout 0.5)."""
    system = entry.build_system(HIDDEN, HIDDEN, FEAT, tp_dropout=0.5,
                                phase2=phase == 2, device=device)
    system.init_params(make_generator(0, device))
    impl = "fused" if device.type == "cuda" else "optax"
    if phase == 1:
        trainable = ["temporal_graph"] + [CKPT_KEYS[t] for t in ACTIVE]
        tasks = ACTIVE
    else:
        banks = entry.random_banks(256, 200, HIDDEN, device=device)
        graphone = GraphONE(entry.AUX_TASKS, features_size=HIDDEN,
                            hidden_size=HIDDEN, k=8, depth=3, residual=True,
                            device=device)
        graphone.reset_parameters(make_generator(2, device))
        system.attach_graphone(graphone)
        trainable = ["temporal_graph", CKPT_KEYS["oscc"], "graphone"]
        tasks = ("oscc",)
    opt = topt.adam(1e-3, 1e-5,
                    trainable_mask=topt.trainable_mask_fn(trainable),
                    impl=impl)
    opt_state = opt.init(system.params())
    if phase == 1:
        step = system.make_train_step(opt, ACTIVE, log_norms=True,
                                      per_layer_norms=True)

        def call(batches, gen):
            return step(opt_state, batches, gen, 1e-3)
    else:
        step = system.make_egopack_train_step(
            opt, ("oscc",), graphone, backprop_temporal_graph=True,
            temporal_graph_train_mode=True, late_fusion=True, log_norms=True)

        def call(batches, gen):
            return step(opt_state, banks, batches, gen, 1e-3)

    def draw(k, batch=BATCH):
        b = entry.make_device_batch_gen(system, batch, FEAT)(100 + k)
        return {t: b[t] for t in tasks}

    return system, opt_state, call, draw


class _KnnLists:
    """The kNN's lists of each step: the tensors GraphONE's
    ``prototype_topk`` returned at the step's call, or, on a replay, those
    it returned at the capture, which the replay wrote anew."""

    def __init__(self, monkeypatch):
        self.last = None
        original = graphone_module.prototype_topk

        def recording(*args, **kwargs):
            self.last = original(*args, **kwargs)
            return self.last

        monkeypatch.setattr(graphone_module, "prototype_topk", recording)

    def read(self):
        return tuple(t.clone() for t in self.last)


def _run(phase, device, monkeypatch):
    """``STEPS`` steps of a fresh step, a new dropout generator from step 7
    on (the driver's next epoch): ``(logs of each step, kNN lists of each
    step, (parameters, first moments, second moments), call, draw)``."""
    knn = _KnnLists(monkeypatch) if phase == 2 else None
    system, opt_state, call, draw = _build(phase, device)
    gens = [make_generator(1, device), make_generator(7, device)]
    logs, lists = [], []
    for k in range(STEPS):
        logs.append(call(draw(k), gens[k >= 7]))
        if knn is not None:
            lists.append(knn.read())
    state = ({n: p.detach().clone() for n, p in system.params().items()},
             {n: t.clone() for n, t in opt_state.mu.items()},
             {n: t.clone() for n, t in opt_state.nu.items()})
    return logs, lists, state, call, draw


def _assert_equal_runs(a, b):
    logs_a, lists_a, state_a = a[:3]
    logs_b, lists_b, state_b = b[:3]
    assert len(logs_a) == len(logs_b) and len(lists_a) == len(lists_b)
    for la, lb in zip(logs_a, logs_b):
        assert sorted(la) == sorted(lb)
        for k in la:
            assert torch.equal(la[k], lb[k]), k
    for xa, xb in zip(lists_a, lists_b):
        assert all(torch.equal(u, v) for u, v in zip(xa, xb))
    for da, db in zip(state_a, state_b):
        for n in da:
            assert torch.equal(da[n], db[n]), n


@pytest.mark.parametrize("phase", [1, 2])
def test_replayed_steps_equal_eager_ones_on_cpu(stub_on_cpu, monkeypatch,
                                                phase):
    """The policy's plumbing, with the stand-in graph: the input buffers,
    the gradient buffers Adam reads, the packed logs and the dropout
    streams carried in and out give the eager steps' numbers exactly, a
    new generator replaying the same graph."""
    cpu = torch.device("cpu")
    tracing.reset()
    graphed = _run(phase, cpu, monkeypatch)
    assert _span_count("egopack.replay") == STEPS - step_graph.EAGER_CALLS
    monkeypatch.setattr(step_graph, "MAX_GRAPHS", 0)
    eager = _run(phase, cpu, monkeypatch)
    _assert_equal_runs(eager, graphed)
    first, second = graphed[0][:2]
    assert not torch.equal(first["grad_norm"], second["grad_norm"])
    tracing.reset()


# ---------------- on the card ----------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [1, 2])
def test_replayed_steps_equal_eager_ones_on_the_card(monkeypatch, phase):
    """3 eager steps and 8 replayed ones against 11 eager ones from the same
    seeds, the dropout generator replaced after 7: every log, the kNN's
    lists, the parameters and both moments bit for bit, the products on the
    split-TF32 kernel; the launch counters and the replay spans count the
    steps; a new batch size captures a second graph, and the first still
    replays."""
    dev = _card()
    eager_calls = step_graph.EAGER_CALLS
    with monkeypatch.context() as m:
        m.setattr(step_graph, "MAX_GRAPHS", 0)
        eager = _run(phase, dev, m)
        again = _run(phase, dev, m)
    _assert_equal_runs(eager, again)  # eager steps repeat bit for bit
    tracing.reset()
    knn0, adam0 = tkt.cosine_knn.launches, tfa.fused_adam.launches
    norms0, gemm0 = tss.sum_squares.launches, gemm.tf32x3_gemm.launches
    captured = StepGraphs.captures
    graphed = _run(phase, dev, monkeypatch)
    torch.cuda.synchronize()
    assert StepGraphs.captures - captured == 1
    assert tfa.fused_adam.launches - adam0 == STEPS
    # the global and per-layer norms: one call, two launches a step
    assert tss.sum_squares.launches - norms0 == 2 * STEPS
    assert tkt.cosine_knn.launches - knn0 == (STEPS if phase == 2 else 0)
    # the linear layers' and GraphONE's products, as many a step (replayed
    # or not) as the step's shapes give
    products = (flops.mtl_step_products() if phase == 1
                else flops.egopack_step_products())
    assert gemm.tf32x3_gemm.launches - gemm0 == products * STEPS
    assert _span_count("egopack.step") == STEPS
    assert _span_count("egopack.replay") == STEPS - eager_calls
    # the forward span opens on the eager calls and the capture alone
    assert _span_count("egopack.forward") == eager_calls + 1
    _assert_equal_runs(eager, graphed)
    logs = graphed[0]
    assert logs[-1]["grad_norm"].data_ptr() != logs[-2]["grad_norm"].data_ptr()
    call, draw = graphed[3:]
    gen = make_generator(11, dev)
    for k in range(eager_calls + 2):
        call(draw(k, BATCH + 1), gen)
    call(draw(STEPS), gen)
    torch.cuda.synchronize()
    assert StepGraphs.captures - captured == 2
    assert _span_count("egopack.replay") == STEPS - eager_calls + 3
    assert tfa.fused_adam.launches - adam0 == STEPS + eager_calls + 3
    tracing.reset()
