"""The float32 products of the linear layers and GraphONE's stages
(``egopack_torch/ops/gemm.py``, kernel ``ops/csrc/tf32x3_gemm.cu``).

On the CPU: the autograd functions' plain path against ``F.linear`` and
``torch.bmm`` bit for bit, forward and gradients; the tiling at each
cell's shapes; the products a train step makes, counted from its shapes.
On the card (``cuda``): every layout at every shape the cells run against
a float64 product, beside cuBLAS in float32 and one TF32 product; two calls
bit for bit; the steps' products off cuBLAS.

This file imports only torch and the port, so it runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_port_gemm.py``.
"""

import itertools

import pytest
import torch
import torch.nn.functional as F

from egopack_torch import entry, flops
from egopack_torch.device import make_generator
from egopack_torch.models.graphone import GraphONE
from egopack_torch.ops import gemm
from egopack_torch.train import optim as topt
from egopack_torch.train.system import CKPT_KEYS, MultiTaskSystem

# Every product of each cell's step at full width, (layout, batch, m, n,
# k): "nt" forward, "nn" an input's gradient, "tn" a weight's. mtl-step:
# 752 nodes (144 AR, 352 LTA, 256 PNR), pooling fc0 over 3 x 1536;
# novel-oscc-step: 64 nodes, OSCC's classifiers on 16 pooled rows;
# novel-lta-step: 352 query rows; GraphONE over 3 tasks.
_MTL = [("nt", 1, 752, 1024, 4608), ("nt", 1, 752, 1024, 1024),
        ("nn", 1, 752, 1024, 1024), ("tn", 1, 1024, 4608, 752),
        ("tn", 1, 1024, 1024, 752)]
for _rows in (144, 352, 256):
    _MTL += [("nt", 1, _rows, 1024, 1024), ("nn", 1, _rows, 1024, 1024),
             ("tn", 1, 1024, 1024, _rows)]
    for _c in ((115, 478) if _rows != 256 else (1,)):
        _MTL += [("nt", 1, _rows, _c, 1024), ("nn", 1, _rows, 1024, _c),
                 ("tn", 1, _c, 1024, _rows)]
_PHASE2 = {"novel-oscc-step": (64, [("nt", 1, 16, 2, 1024),
                                    ("nn", 1, 16, 1024, 2),
                                    ("tn", 1, 2, 1024, 16)]),
           "novel-lta-step": (352, [(lay, 1, m, n, k) for lay, _, m, n, k
                                    in _MTL if 352 in (m, k)
                                    and {m, n, k} & {115, 478}])}
CELL_SHAPES = {"mtl-step": _MTL}
for _cell, (_rows, _cls) in _PHASE2.items():
    CELL_SHAPES[_cell] = [("nt", 1, _rows, 1024, 4608),
                          ("tn", 1, 1024, 4608, _rows)] + [
        (lay, b, m, n, k) for b in (1, 3) for lay, m, n, k in (
            ("nt", _rows, 1024, 1024), ("nn", _rows, 1024, 1024),
            ("tn", 1024, 1024, _rows))] + _cls

# products of one train step, counted from the configurations' shapes
# (``egopack_torch/flops.py``): phase 1 over AR, LTA and PNR; novel OSCC
# over a backbone that trains, its one classifier with 3 aux sets; novel LTA
# over a frozen backbone (forward only, no input gradient into its head),
# its verb and noun classifiers with the published 3 aux sets each;
# GraphONE over 3 tasks at depth 3
PRODUCTS = {"mtl": flops.mtl_step_products(),
            "oscc": flops.egopack_step_products(),
            "lta": flops.egopack_step_products(heads=2,
                                               backbone_trains=False)}


# ---------------- on the CPU ----------------

def _leaf(shape, seed, grad=True):
    t = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return t.requires_grad_(grad)


@pytest.mark.parametrize("bias,rows,grads", itertools.product(
    [True, False], [(7,), (2, 5)], ["all", "weight", "input"]))
def test_linear_function_matches_f_linear_on_cpu(bias, rows, grads):
    """Forward and every gradient equal to ``F.linear``'s bit for bit;
    only the gradients asked for are made."""
    x = _leaf(rows + (13,), 0, grads != "weight")
    w = _leaf((11, 13), 1, grads != "input")
    b = _leaf((11,), 2, grads != "input") if bias else None
    g = _leaf(rows + (11,), 3, False)
    ours = gemm.linear(x, w, b)
    want = F.linear(x, w, b)
    assert torch.equal(ours, want)
    inputs = [t for t in (x, w, b) if t is not None and t.requires_grad]
    got = torch.autograd.grad(ours, inputs, g)
    ref = torch.autograd.grad(want, inputs, g)
    for u, v in zip(got, ref):
        assert torch.equal(u, v)


@pytest.mark.parametrize("grads", ["both", "a", "w"])
def test_bmm_function_matches_torch_bmm_on_cpu(grads):
    a = _leaf((3, 7, 13), 0, grads != "w")
    w = _leaf((3, 13, 5), 1, grads != "a")
    g = _leaf((3, 7, 5), 2, False)
    ours, want = gemm.bmm(a, w), torch.bmm(a, w)
    assert torch.equal(ours, want)
    inputs = [t for t in (a, w) if t.requires_grad]
    for u, v in zip(torch.autograd.grad(ours, inputs, g),
                    torch.autograd.grad(want, inputs, g)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("layout,batch", itertools.product(
    ["nt", "nn", "tn"], [1, 3]))
def test_plain_version_of_each_layout(layout, batch):
    """``tf32x3_gemm`` on CPU tensors: the layout's product, against a
    float64 one; ``dims`` reads its sizes."""
    m, n, k = 5, 7, 9
    a_shape = (k, m) if layout == "tn" else (m, k)
    b_shape = (n, k) if layout == "nt" else (k, n)
    lead = (batch,) if batch > 1 else ()
    a, b = _leaf(lead + a_shape, 4, False), _leaf(lead + b_shape, 5, False)
    bias = _leaf((n,), 6, False)
    assert gemm.dims(a, b, layout) == (batch, m, n, k)
    lhs = a.double().transpose(-1, -2) if layout == "tn" else a.double()
    rhs = b.double().transpose(-1, -2) if layout == "nt" else b.double()
    want = lhs @ rhs + bias.double()
    got = gemm.tf32x3_gemm(a, b, layout, bias)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("a_shape,b_shape,layout", [
    ((4, 5), (6, 7), "nt"), ((4, 5), (6, 7), "nn"), ((4, 5), (6, 7), "tn"),
    ((2, 4, 5), (3, 5, 6), "nn"), ((4, 5), (2, 5, 6), "nn"),
    ((4, 5), (6, 5), "xx")])
def test_operands_that_do_not_fit_raise(a_shape, b_shape, layout):
    with pytest.raises(ValueError):
        gemm.dims(torch.ones(a_shape), torch.ones(b_shape), layout)


@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_tiling_at_each_cells_shapes(cell):
    """At every product of a cell the plan's splits are equal runs of whole
    k-steps, its grid keeps at least half the card's 132 multiprocessors
    busy (or makes half the blocks the shape can, where that is fewer), and
    among such plans it is the cost model's least."""
    for layout, batch, m, n, k in CELL_SHAPES[cell]:
        p = gemm.plan(batch, m, n, k)
        k_tiles = -(-k // gemm.BK)
        assert p.splits * p.tiles_per_split == k_tiles, (m, n, k, p)
        assert p.splits <= gemm.MAX_SPLITS
        others = [gemm.Plan(wg, cols, s, k_tiles // s)
                  for wg, cols in gemm.TILES for s in range(1, k_tiles + 1)
                  if k_tiles % s == 0 and s <= gemm.MAX_SPLITS]
        most = max(gemm.blocks(batch, m, n, q) for q in others)
        got = gemm.blocks(batch, m, n, p)
        assert 2 * got >= min(gemm.SMS, most), (layout, m, n, k, p, got)
        assert gemm.cost_us(batch, m, n, p) == min(
            gemm.cost_us(batch, m, n, q) for q in others
            if 2 * gemm.blocks(batch, m, n, q) >= min(gemm.SMS, most))


def _small_step(case, device):
    """A train step at a small width (feat 16, hidden 32, batch 2):
    ``call()`` runs one step. ``"mtl"`` trains the backbone and the AR, LTA
    and PNR heads; ``"oscc"`` novel OSCC with GraphONE (depth 3) over AR,
    LTA and PNR, the backbone training; ``"lta"`` novel LTA with GraphONE
    over AR, OSCC and PNR and the published aux sets, the backbone frozen
    and in eval mode."""
    system = entry.build_system(32, 32, 16, phase2=case != "mtl",
                                device=device)
    system.init_params(make_generator(0, device))
    if case == "mtl":
        trainable = ["temporal_graph"] + [CKPT_KEYS[t] for t in entry.ACTIVE]
        tasks = entry.ACTIVE
    else:
        banks = entry.random_banks(256, 200, 32, device=device)
        if case == "lta":
            banks = {"ar": banks["ar"], "oscc": banks["lta"],
                     "pnr": banks["pnr"]}
            lta = system.tasks["lta"]
            lta.head = type(lta.head)("lta", 32, 32,
                                      heads=(entry.N_VERBS, entry.N_NOUNS),
                                      aux_tasks=("ar", "oscc", "pnr"),
                                      device=device)
            system = MultiTaskSystem(system.backbone, system.tasks,
                                     device=device)
            system.init_params(make_generator(0, device))
        graphone = GraphONE(tuple(banks), features_size=32, hidden_size=32,
                            k=4, depth=3, residual=True, device=device)
        graphone.reset_parameters(make_generator(2, device))
        system.attach_graphone(graphone)
        tasks = (case,)
        trainable = ([] if case == "lta" else ["temporal_graph"]) + [
            CKPT_KEYS[case], "graphone"]
    opt = topt.adam(1e-3, 1e-5,
                    trainable_mask=topt.trainable_mask_fn(trainable),
                    impl="fused" if device.type == "cuda" else "optax")
    state = opt.init(system.params())
    batches = entry.make_device_batch_gen(system, 2, 16)(3)
    batches = {t: batches[t] for t in tasks}
    gen = make_generator(1, device)
    if case == "mtl":
        step = system.make_train_step(opt, tasks, log_norms=True)
        return lambda: step(state, batches, gen, 1e-3)
    frozen = case == "lta"
    step = system.make_egopack_train_step(
        opt, tasks, graphone, backprop_temporal_graph=not frozen,
        temporal_graph_train_mode=not frozen, late_fusion=True,
        log_norms=True)
    return lambda: step(state, banks, batches, gen, 1e-3)


@pytest.mark.parametrize("case", sorted(PRODUCTS))
def test_products_a_step_counted_from_shapes_on_cpu(case, monkeypatch):
    """Every float32 product of the step goes through ``tf32x3_gemm``, as
    many as the shapes give, each gradient only where one is needed."""
    seen = []
    plain = gemm.tf32x3_gemm

    def counting(a, b, layout, bias=None):
        seen.append(layout)
        return plain(a, b, layout, bias)

    monkeypatch.setattr(gemm, "tf32x3_gemm", counting)
    _small_step(case, torch.device("cpu"))()
    assert len(seen) == PRODUCTS[case]


# ---------------- on the card ----------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(layout, batch, m, n, k, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = (batch,) if batch > 1 else ()
    a_shape = (k, m) if layout == "tn" else (m, k)
    b_shape = (n, k) if layout == "nt" else (k, n)
    a = torch.randn(lead + a_shape, device=dev, generator=gen)
    b = torch.randn(lead + b_shape, device=dev, generator=gen)
    return a, b, torch.randn(n, device=dev, generator=gen)


def _rms(x):
    return float(x.double().square().mean().sqrt())


def _tf32(x):
    """``x`` split as the kernel splits it: ``hi``, ``x`` rounded to TF32
    (Veltkamp's split in float32), and ``lo``, ``x - hi`` as the tensor
    cores read it (its 13 low bits dropped): ``(hi, lo)``."""
    t = x * 8193.0
    hi = t - (t - x)
    lo = ((x - hi).view(torch.int32) & -8192).view(torch.float32)
    return hi, lo


def _floors(a, b, layout, bias, want):
    """The RMS errors against ``want`` of the split's own products summed
    exactly (``a_hi b_hi + a_hi b_lo + a_lo b_hi`` in float64: what 3xTF32
    keeps), and of one TF32 product (``a_hi b_hi``: what 1xTF32 keeps)."""
    (ah, al), (bh, bl) = _tf32(a), _tf32(b)
    ref = gemm.tf32x3_gemm_reference
    one = ref(ah.double(), bh.double(), layout, bias.double())
    three = (one + ref(ah.double(), bl.double(), layout)
             + ref(al.double(), bh.double(), layout))
    return _rms(three - want), _rms(one - want)


SHAPES = sorted({(lay, m, n, k) for cell in CELL_SHAPES.values()
                 for lay, _, m, n, k in cell})


@pytest.mark.cuda
@pytest.mark.parametrize("layout,batch", itertools.product(
    ["nt", "nn", "tn"], [1, 3]))
def test_kernel_at_every_cell_shape_on_the_card(layout, batch):
    """Each shape of the cells in this layout (N 1, 2, 115, 478; M 1 to
    1024; K 1 to 4608, ragged edges included), bias on, the error's RMS
    against a float64 product: within 2x of cuBLAS float32's on the same
    inputs, or of the split's own floor where that is larger (at K of 1
    and 2 cuBLAS rounds once, and the product a_lo b_lo that 3xTF32 drops
    is about twice that); and at least 10x under one TF32 product's; no
    NaN; one launch."""
    dev = _card()
    bad = []
    for lay, m, n, k in SHAPES:
        if lay != layout:
            continue
        a, b, bias = _operands(layout, batch, m, n, k, dev, m * n + k)
        launches = gemm.tf32x3_gemm.launches
        got = gemm.tf32x3_gemm(a, b, layout, bias)
        torch.cuda.synchronize()
        assert gemm.tf32x3_gemm.launches - launches == 1
        assert got.shape == ((batch, m, n) if batch > 1 else (m, n))
        want = gemm.tf32x3_gemm_reference(a.double(), b.double(), layout,
                                          bias.double())
        err = _rms(got - want)
        f32 = _rms(gemm.tf32x3_gemm_reference(a, b, layout, bias) - want)
        floor, tf32 = _floors(a, b, layout, bias, want)
        print(f"{layout} b{batch} {m}x{n}x{k} {gemm.plan(batch, m, n, k)}: "
              f"rms err {err:.3e}, cuBLAS f32 {f32:.3e}, split floor "
              f"{floor:.3e}, TF32 {tf32:.3e}")
        if not (torch.isfinite(got).all() and err <= 2 * max(f32, floor)
                and 10 * err <= tf32):
            bad.append((m, n, k, err, f32, floor, tf32))
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("layout,batch,m,n,k", [
    ("tn", 1, 1024, 1024, 752), ("nt", 1, 64, 1024, 4608),
    ("nn", 3, 64, 1024, 1024), ("nt", 1, 37, 115, 30),
    ("tn", 1, 115, 1024, 144)])
def test_kernel_repeats_bit_for_bit_on_the_card(layout, batch, m, n, k):
    """Two calls on the same inputs, and a CUDA graph's replays of the
    call, give the same bits, split over K or not; a misaligned operand
    takes the 4-byte copies; a non-contiguous one raises."""
    dev = _card()
    a, b, bias = _operands(layout, batch, m, n, k, dev, 11)
    first = gemm.tf32x3_gemm(a, b, layout, bias)
    again = gemm.tf32x3_gemm(a, b, layout, bias)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = gemm.tf32x3_gemm(a, b, layout, bias)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, captured)
    # the same values one float past a 16-byte boundary
    shifted = torch.empty(a.numel() + 1, device=dev)[1:].view(a.shape)
    shifted.copy_(a)
    odd = gemm.tf32x3_gemm(shifted, b, layout, bias)
    torch.cuda.synchronize()
    want = gemm.tf32x3_gemm_reference(a.double(), b.double(), layout,
                                      bias.double())
    assert _rms(odd - want) <= 2 * _rms(first - want) + 1e-12
    with pytest.raises(ValueError):
        gemm.tf32x3_gemm(a.transpose(-1, -2), b, layout)
    with pytest.raises(TypeError):
        gemm.tf32x3_gemm(a.double(), b, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [1, 2])
def test_steps_products_leave_cublas_on_the_card(phase):
    """A profiled eager step at full width: every product op left on
    cuBLAS has the adjacency's ``(M, M)`` operand or a LayerNorm
    statistic's ``(3, M)`` one, so no linear layer's or GraphONE's product
    does; the kernel runs the step's products, as many as ``PRODUCTS``
    counts."""
    dev = _card()
    if phase == 1:
        step = entry.build_mtl_step(device=dev, device_batches=True)
    else:
        step = entry.build_egopack_step(device=dev, device_batches=True)
    step()
    torch.cuda.synchronize()
    launches = gemm.tf32x3_gemm.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    assert (gemm.tf32x3_gemm.launches - launches
            == PRODUCTS["mtl" if phase == 1 else "oscc"])
    left = []
    for e in prof.events():
        if e.name in ("aten::mm", "aten::bmm", "aten::addmm", "aten::mv"):
            shapes = [tuple(s) for s in e.input_shapes if s]
            square = any(len(s) >= 2 and s[-1] == s[-2] != 1024
                         for s in shapes)
            # (T, M) task one-hots, T = 3 tasks, against a vector
            stats = any(len(s) == 2 and 3 in s for s in shapes)
            if not (square or stats):
                left.append((e.name, shapes))
    assert not left, left
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("tf32x3_gemm" in n for n in names), sorted(names)[:20]
