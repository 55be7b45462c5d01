"""The port's bench (``python -m egopack_torch.bench``) on the CPU, at the
small knobs; its numbers are the CPU's and stand for nothing.

- The shape-derived FLOP count of one step of each line equals what
  ``torch.utils.flop_counter.FlopCounterMode`` counts over the same step on
  the CPU, within 1% (here: exactly). Neither side counts the
  matrix-vector products of the concat layout's graph LayerNorm
  statistics (``aten::mv``, a few ``T × M`` each), nor elementwise work.
- The CLI prints exactly two JSON lines with ``bench.py``'s keys; the
  peak is pinned low so that ``mfu`` cannot round to 0.0 on a loaded host.
- ``run_interleaved_arms`` honours ``BENCH_WINDOWS``; ``require_device``
  exits 3 with no JSON when the device does not answer.
- The batches made on the device keep the host batches' shapes, dtypes and
  label ranges (``__graft_entry__.make_device_batch_gen``'s contract).
- The peak table reads the card's name as ``nvidia-smi`` prints it.
- XLA's ``cost_analysis`` of the JAX phase-1 step (what ``bench.py``
  reports) counts the same products plus the elementwise work, so it reads
  a little above the shape count, by less as the width grows; printed."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from egopack_torch import bench, flops, profiling
from egopack_torch.entry import (build_egopack_step, build_mtl_step,
                                 build_system, make_device_batch_gen,
                                 synthetic_batches)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "tflops", "mfu"}


def _counted(step, lr):
    step(lr)  # the first call builds the layout constants
    with FlopCounterMode(display=False) as fc:
        step(lr)
    return fc.get_total_flops()


@pytest.mark.parametrize("layout,spc,kw", [
    ("concat", 1, {}),
    ("slice", 1, {}),
    ("concat", 2, {"compute_dtype": torch.bfloat16}),
    ("slice", 1, {"compute_dtype": torch.bfloat16,
                  "propagate_dtype": torch.bfloat16}),
])
def test_mtl_flops_match_flop_counter(layout, spc, kw):
    step = build_mtl_step(4, 24, 32, tp_dropout=0.0, fused_layout=layout,
                          steps_per_call=spc, device="cpu", **kw)
    ours = spc * flops.mtl_step_flops(4, 24, 32, layout)
    assert ours == pytest.approx(_counted(step, 1e-3), rel=0.01)


@pytest.mark.parametrize("batch,spc,kw", [
    (4, 1, {}), (3, 2, {"compute_dtype": torch.bfloat16})])
def test_egopack_flops_match_flop_counter(batch, spc, kw):
    step = build_egopack_step(batch, 24, 32, p_pad=128, fill=100,
                              steps_per_call=spc, device="cpu", **kw)
    ours = spc * flops.egopack_step_flops(batch, 24, 32, 128)
    assert ours == pytest.approx(_counted(step, 1e-6), rel=0.01)


def test_auto_layout_follows_the_system():
    # 16 x 47 nodes stay under the concat bound, 30 x 47 do not
    assert flops.mtl_step_flops(16, 8, 8) == flops.mtl_step_flops(
        16, 8, 8, "concat")
    assert flops.mtl_step_flops(30, 8, 8) == flops.mtl_step_flops(
        30, 8, 8, "slice")


def test_bench_cli_prints_two_lines():
    env = dict(os.environ, BENCH_DEVICE="cpu", BENCH_FEAT_DIM="16",
               BENCH_HIDDEN="32", BENCH_BATCH="2", BENCH_WINDOWS="2",
               BENCH_STEPS_PER_CALL="2", BENCH_DTYPE="bfloat16",
               BENCH_MOMENTS_DTYPE="float32", BENCH_PEAK_TFLOPS="0.1",
               OMP_NUM_THREADS="1")
    env.pop("BENCH_SKIP_EGOPACK", None)
    env.pop("BENCH_BF16_PROP", None)
    proc = subprocess.run([sys.executable, "-m", "egopack_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(l) for l in proc.stdout.splitlines()
             if l.startswith("{")]
    assert [l["metric"] for l in lines] == [
        "ego4d_mtl_clips_per_sec_per_chip_fwd_bwd",
        "ego4d_egopack_oscc_clips_per_sec_per_chip_fwd_bwd"]
    for line in lines:
        assert set(line) == KEYS
        assert line["unit"] == "clips/s/chip"
        assert line["value"] > 0 and line["vs_baseline"] > 0
        assert line["tflops"] >= 0 and 0 < line["mfu"] < 1
    notes = [l for l in proc.stdout.splitlines() if l.startswith("# ")]
    assert len(notes) == 2 and all("TFLOP/s" in n for n in notes)


def test_interleaved_arms_honour_windows(monkeypatch):
    calls = {"n": 0}

    def step(lr):
        calls["n"] += 1

    arms = {"a": {"step": step, "spc": 2, "lr": 0.0,
                  "device": torch.device("cpu")}}
    monkeypatch.setenv("BENCH_WINDOWS", "2")
    out = bench.run_interleaved_arms(arms, steps=3)
    assert calls["n"] == 3 + 2 * 3  # warm-up + windows x steps
    assert set(out) == {"a"} and out["a"] >= 0.0


def test_build_arms_on_the_cpu(monkeypatch):
    for k, v in (("BENCH_DEVICE", "cpu"), ("BENCH_FEAT_DIM", "16"),
                 ("BENCH_HIDDEN", "32"), ("BENCH_BATCH", "2")):
        monkeypatch.setenv(k, v)
    arms = bench.build_arms([("f32", {"bf16_prop": False}),
                             ("prop", {"bf16_prop": True})], 2)
    assert arms["prop"]["step"].system.backbone.propagate_dtype \
        == torch.bfloat16
    out = bench.run_interleaved_arms(arms, steps=1, windows=1)
    assert set(out) == {"f32", "prop"}


def test_require_device_exits_3_without_json():
    """The probe never returns: past the timeout the process exits with
    code 3 and prints a line that is not JSON."""
    code = ("import time\nfrom egopack_torch import bench\n"
            "bench._probe = lambda device: time.sleep(60)\n"
            "bench.main()\n")
    env = dict(os.environ, BENCH_DEVICE="cpu", BENCH_DEVICE_TIMEOUT="0.5")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, (proc.returncode, proc.stderr[-500:])
    assert "device unreachable" in proc.stdout
    assert not [l for l in proc.stdout.splitlines() if l.startswith("{")]


def test_bench_needs_a_card(monkeypatch):
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main()


def test_device_batches_keep_the_host_contract():
    system = build_system(32, 32, 16, device="cpu")
    host = synthetic_batches(system, 4, 16, seed=0)
    gen = make_device_batch_gen(system, 4, 16)
    a, b = gen(0), gen(1)
    assert set(a) == set(host)
    for name, ref in host.items():
        for k, v in ref.items():
            assert a[name][k].shape == v.shape and a[name][k].dtype == v.dtype
    assert not torch.equal(a["ar"]["x"], b["ar"]["x"])
    assert torch.equal(gen(0)["ar"]["x"], a["ar"]["x"])  # seeded
    n = system.tasks["ar"].spec.num_nodes
    ar = a["ar"]["y"]
    assert bool((ar[:, n // 2, 0] < 115).all()) and bool(
        (ar[:, n // 2, 1] < 478).all())
    assert int((ar >= 0).sum()) == 2 * 4  # one labelled node per sample
    lta = a["lta"]["y"]
    assert bool((lta[:, :2] == -1).all()) and bool((lta[:, 2:, 0] >= 1).all())
    assert bool((a["pnr"]["y"].sum(1) == 1).all())
    assert set(np.unique(a["oscc"]["y"].numpy())) <= {0, 1}
    assert bool(a["oscc"]["valid"].all())


def test_peaks_by_card_name():
    assert profiling.bf16_peak("NVIDIA H100 80GB HBM3") == 989.4e12
    assert profiling.bf16_peak("NVIDIA H100 NVL") == 835.5e12
    assert profiling.bf16_peak("NVIDIA H100 PCIe") == 756e12
    assert profiling.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert profiling.tf32_peak("NVIDIA H100 80GB HBM3") == 495e12
    assert profiling.fp32_peak("NVIDIA H100 PCIe") == 51e12
    with pytest.raises(RuntimeError, match="bf16 peak"):
        profiling.bf16_peak("NVIDIA A100-SXM4-80GB")


def test_xla_cost_analysis_counts_the_products_and_more(capsys):
    """``bench.py``'s FLOPs for one phase-1 step (steps_per_call 1, bf16
    compute), compiled on the CPU at two reduced widths, against the shape
    count: XLA adds one operation per element of every elementwise op,
    which weighs less as the products grow (the full width is not compiled
    on the CPU)."""
    import __graft_entry__ as ge
    from egopack_tpu.train import optim as jopt
    from egopack_tpu.train.driver import CKPT_KEYS, trainable_mask_fn

    ratios = []
    for batch, feat, hidden in ((4, 24, 32), (16, 384, 256)):
        system = ge._build_system(hidden, hidden, feat)
        system.compute_dtype = jnp.bfloat16
        params = system.init_params(jax.random.PRNGKey(0), feat)
        opt = jopt.adam(1e-5, 1e-5, impl="fused", trainable_mask=(
            trainable_mask_fn(["temporal_graph"]
                              + [CKPT_KEYS[t] for t in bench.ACTIVE])))
        step = system.make_train_step(opt, bench.ACTIVE)
        batches = {n: b for n, b in ge._synthetic_batches(
            system, batch, feat).items() if n in bench.ACTIVE}
        cost = step.lower(params, opt.init(params), batches,
                          jax.random.PRNGKey(1), 1e-5).compile()
        cost = cost.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        ours = flops.mtl_step_flops(batch, feat, hidden)
        ratios.append(float(cost["flops"]) / ours)
        with capsys.disabled():
            print(f"\nphase-1 step batch {batch} feat {feat} hidden "
                  f"{hidden}: XLA cost_analysis {cost['flops']!r} flop, "
                  f"shape count {ours}, ratio {ratios[-1]!r}")
    assert 1.0 < ratios[1] < ratios[0] < 1.25
