"""The metrics that read the card's kernels by name, on hand-built
stretches: they read alike whether the step ran eagerly or replayed a CUDA
graph, since the kernels keep their names."""

import pytest

from benchmark.harness.manifest import Manifest
from benchmark.harness.trace import Context
from benchmark.harness.window import Stretch, WindowResult

CARD = "NVIDIA H100 80GB HBM3"


def _ctx(*stretches):
    return Context({}, CARD, WindowResult(stretches=list(stretches)), 0, 0)


def _read(name, ctx):
    return Manifest().metric_module(name).read(ctx)


def _device(t0):
    """One step's kernels, as the profiler names them (durations in us)."""
    return [("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8",
             t0, t0 + 100.0),
            ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn>",
             t0 + 110, t0 + 150),
            ("void gemv2T_kernel_val<int, int, float, float, float>",
             t0 + 160, t0 + 170),
            ("void sgemm_largek_lds64<true, false, 5, 5, 4, 4, 4, 34>",
             t0 + 180, t0 + 200),
            ("void cublasLt::splitKreduce_kernel<32, 16, int, float>",
             t0 + 200, t0 + 203),
            ("void scal_kernel<float, float, 1, true, 6, 5, 5, 3>"
             "(cublasTransposeParams<float>, float const*)", t0 + 203, t0 + 204),
            ("Memset (Device)", t0 + 204, t0 + 205),
            ("knn_partial_gemm_tiles", t0 + 210, t0 + 260),
            ("void at::native::reduce_kernel<512, 1>", t0 + 270, t0 + 300),
            ("adam_kernel", t0 + 300, t0 + 330),
            ("Memcpy DtoD (Device -> Device)", t0 + 330, t0 + 331)]


def test_matmul_time_by_kernel_name():
    card_only = Stretch(2, _device(0) + _device(1000), [], 0, False)
    # a stretch that recorded the host's operations is not read
    with_host = Stretch(1, _device(5000), [("aten::mm", 0, 1)], 0, True)
    got = _read("matmul_device_ms_per_step", _ctx(card_only, with_host))
    assert got == pytest.approx((100 + 40 + 10 + 20 + 3 + 1) / 1e3)


def test_matmul_reads_nothing_without_products():
    is_product = Manifest().metric_module(
        "matmul_device_ms_per_step").is_product
    device = [e for e in _device(0) if not is_product(e[0])]
    device.append(("knn_partial_gemm_tiles", 0, 5))
    ctx = _ctx(Stretch(1, device, [], 0, False))
    assert _read("matmul_device_ms_per_step", ctx) is None
    assert _read("matmul_device_ms_per_step", _ctx()) is None


# the ops that launch the products' kernels: on the card ``aten::mv``
# runs its kernels under ``aten::addmv_``; the program's split-TF32 GEMM
# (``egopack_torch/ops/gemm.py``) launches its kernels under its autograd
# functions, forward and backward
PRODUCT_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
               "aten::mv", "aten::addmv", "aten::addmv_", "_Linear",
               "_LinearBackward", "_Matmul", "_MatmulBackward")
# what a product op may launch that no name tells from the step's other
# work: fills, and torch's own copies
NOT_NAMED = ("Memset", "at::native::")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("mtl-step", "novel-oscc-step"))
def test_matmul_names_are_the_product_ops_kernels(card, cell):
    """In the eager first steps at the cell's own size, after as many
    unprofiled ones (which load the kernels lazily), the kernels that the
    product ops launch are those the metric names, but for fills and
    copies worth under 2% of their time, and no kernel it names runs under
    another op. The kernels by op go to standard output."""
    import collections
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import cell as cells, inputs
    from benchmark.tests.tiny import manifest

    is_product = Manifest().metric_module(
        "matmul_device_ms_per_step").is_product
    cfg, traffic, kind = manifest().setting(cell)
    seeds = inputs.stream_seeds(2147483911)
    feed, step, _ = cells.program_first_steps(cfg, traffic, kind, seeds, card)
    feed.close()
    del feed, step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        feed, step, _ = cells.program_first_steps(cfg, traffic, kind, seeds,
                                                  card)
        torch.cuda.synchronize()
    feed.close()
    under = collections.defaultdict(float)  # "op > kernel" -> us
    elsewhere = collections.defaultdict(float)
    for ev in prof.events():
        for k in ev.kernels:
            into = under if ev.name in PRODUCT_OPS else elsewhere
            into[f"{ev.name} > {k.name}"] += k.duration
    named = {k: us for k, us in under.items() if is_product(k)}
    not_named = {k: us for k, us in under.items() if not is_product(k)}
    extra = {k: us for k, us in elsewhere.items() if is_product(k)}
    ops_us = sum(under.values())
    print(json.dumps({
        "cell": cell, "ops_us": ops_us, "named_us": sum(named.values()),
        "not_named": not_named, "extra": extra,
        "under_ops": dict(sorted(under.items(), key=lambda kv: -kv[1]))}))
    assert ops_us > 0, "no product op launched a kernel"
    assert all(any(n in k.split(" > ", 1)[1] for n in NOT_NAMED)
               for k in not_named), not_named
    assert sum(not_named.values()) < 0.02 * ops_us
    assert not extra
