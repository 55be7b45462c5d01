#!/usr/bin/env python3
"""Drive the PyTorch port (``egopack_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero and prints no result:

1. build   - compile every kernel of the paths from ``egopack_torch/ops/csrc``
             with nvcc for sm_90a (into ``egopack_torch/_build/``), one nvcc
             per source, all started together.
2. kernels - fused Adam against its plain PyTorch version over the full-width
             leaf set (61 trainable leaves + the frozen OSCC head), 3 steps
             with float32 and 3 with bfloat16 moments. Tolerance: one unit in
             the last place of the stored dtype (the kernel is built with
             --fmad=false and is expected to agree bit for bit); frozen
             leaves bit-identical. The cosine-kNN kernel against its plain
             version at T=3, M=64, F=1024, k=8 for P=2048 (1900 valid),
             P=1999 (80% valid), P=55,040 (50,000 valid) and P=256 (5 valid):
             distances within 1e-5, indices equal but for near-ties (two
             distances within 1e-5), whose count is printed.
3. train   - the phase-1 AR+LTA+PNR train step at full width (hidden 1024,
             feat 1536, batch 16 per task, fused Adam, dropout 0.5 from a
             seeded generator): 3 warm-up + 20 timed steps. Launch counts are
             zeroed just before and read just after. Finite losses, moved
             trainable parameters, an unchanged OSCC head. Then one step with
             dropout off against the same step with the plain Adam, and a
             small model on the card against the same model on the CPU.
4. driver - the phase-1 CLI (``egopack_torch.main_temporal.main``) at
             full width on a seeded Ego4D-layout fixture (1536-d features,
             115 verbs, 478 nouns, 15 AR steps an epoch at batch 16): 3
             epochs of AR+LTA+PNR with fused Adam, dropout 0.5, full-state
             checkpoints and the MTL_ar-lta-pnr artifact, counts zeroed just
             before and read just after. Finite epoch losses, one fused_adam
             launch per optimizer step, meter blocks for AR, LTA and PNR, the
             native feature gather in use, the artifact read back equal bit
             for bit to the trained parameters; then a second call with
             num_epochs=4 that resumes at epoch 4. Prints ms per optimizer
             step over epochs 2-3 (wall clock, data loading included).
5. egopack_driver - the phase-2 CLI (``egopack_torch.main_egopack.main``)
             at full width from the driver's MTL_ar-lta-pnr artifact, on a
             second fixture of the same widths with 240 OSCC windows (15
             OSCC steps an epoch at batch 16): novel OSCC, GraphONE k=8
             depth 3, fused Adam at 1e-6, head dropout 0.5, 3 epochs with
             checkpoints and the MTL_oscc artifact, counts zeroed just
             before and read just after. Finite epoch losses, one fused_adam
             launch per optimizer step, one cosine_knn launch per optimizer
             step and per OSCC validation batch, an OSCC meter block, the
             artifact's banks and masks equal to the banks built; then a
             second call with num_epochs=4 that resumes at epoch 4. Prints
             ms per optimizer step over epochs 2-3, the wait for data and
             the prototype sweep's seconds.
6. evaluate - ``egopack_torch.evaluate`` cold on MTL_oscc: the driver's
             last OSCC validation again (accuracy equal, loss within rtol
             1e-5), one cosine_knn launch per validation batch.
7. egopack - the phase-2 novel-OSCC EgoPack step at full width: the
             phase-1 state of the driver's artifact (``load_artifact``, then
             ``interop.from_flax``) merged into the phase-2 system, banks
             built on the card from 8 seeded AR batches of 256 clips, then 3
             warm-up + 20 timed steps with the kNN kernel and fused Adam
             (counts zeroed just before, read just after: one launch of each
             per step). Finite losses, moved trainable leaves, the other
             heads and the banks bit-identical. One step with the plain kNN
             from the same state, the eval step, and a small phase-2 model on
             the card against the CPU.
8. bench   - ``python -m egopack_torch.bench`` in a process of its own at
             full width and the bench's defaults (bf16 compute, float32
             moments) but steps_per_call 8 and 2 windows: both JSON lines
             parse with bench.py's keys, ``tflops`` above 0 and ``0 < mfu <
             1``. Then one call of each line at the same settings in this
             process, counts zeroed just before and read just after: 8
             fused_adam launches in line 1, 8 fused_adam and 8 cosine_knn
             in line 2.
9. bf16    - one phase-1 and one phase-2 step at full width with
             compute_dtype=bfloat16, then with propagate_dtype=bfloat16,
             against the float32 steps from the same state: relative loss
             gaps printed, each below 2**-5. Small models of both settings,
             3 steps, card against CPU (bf16 compute: rtol 1e-4 / atol
             1e-5; bf16 propagation: losses within one bf16 unit, rtol
             2**-7, parameters within 2 lr a step). One phase-1 step of
             each setting under ``torch.profiler``: busy time, idle share,
             device events, top kernels, and the GEMM kernels by their
             operands' type; the bf16 steps must run GEMMs on bf16 operands
             (cuBLAS on the tensor cores, float32 output), the float32 step
             none.
10. numbers - ms per step; each kernel's device time, launches and bound;
             the plain versions' times; one library call each as yardstick
             (timed only; the port never calls it):
             ``torch.optim.Adam(fused=True)`` and ``torch.topk`` over the
             masked ``1 - bmm``. The card's clocks, power and temperature
             are read beside each kNN window.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import egopack_torch
from egopack_torch import interop
from egopack_torch.data.synthetic import generate_ego4d_fixture
from egopack_torch.device import make_generator
from egopack_torch.entry import (ACTIVE, AUX_TASKS, N_NOUNS, N_VERBS,
                                 build_egopack_step, build_mtl_step,
                                 build_system, synthetic_batches)
from egopack_torch.evaluate import main as evaluate_main
from egopack_torch.io import native
from egopack_torch.main_egopack import main as egopack_main
from egopack_torch.main_temporal import main as train_main
from egopack_torch.ops import fused_adam as tfa
from egopack_torch.ops import knn_topk as tkt
from egopack_torch.ops.knn import prototype_topk
from egopack_torch.profiling import (busy_us, device_events, fp32_peak,
                                     hbm_bytes_per_s, mean_us, tf32_peak)
from egopack_torch.train import optim as topt
from egopack_torch.train.checkpoint import load_artifact
from egopack_torch.train.system import CKPT_KEYS

HERE = Path(__file__).resolve().parent
FEAT, HIDDEN, BATCH = 1536, 1024, 16
LR, WD = 1e-5, 1e-5
LR_EGO = 1e-6  # the phase-2 Adam rate (egopack_tpu/train/driver.py:627-636)
WARMUP, TIMED = 3, 20
TRAINABLE = ["temporal_graph"] + [CKPT_KEYS[t] for t in ACTIVE]
F32_ULP, BF16_ULP = 2.0 ** -23, 2.0 ** -7
# float32 operations of one Adam element: decay 2, moments 6, update 5
ADAM_FLOPS_PER_ELEM = 13
K, PROTO_BATCH, PROTO_BATCHES = 8, 256, 8
KNN_TOL = 1e-5
# (P, valid rows) of the kNN kernel checks; valid < 1 is a random share
KNN_CASES = ((2048, 1900), (1999, 0.8), (55040, 50000), (256, 5))
KNN_PASSES = ("knn_partial", "knn_merge")  # the kernels of one kNN call
# the driver's fixture: 8 videos of 30 actions give 240 AR clips (15 steps
# of 16 an epoch); 64 OSCC windows give about 32 PNR clips (2 batches)
DRIVER_VIDEOS, DRIVER_OSCC, DRIVER_EPOCHS = 8, 64, 3
ARTIFACT = "MTL_ar-lta-pnr"
# the phase-2 driver's fixture: 240 OSCC windows a split give 15 optimizer
# steps and 15 validation batches of 16 an epoch
EGOPACK_OSCC, EGOPACK_ARTIFACT = 240, "MTL_oscc"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def gpu_clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature, as
    nvidia-smi reads them now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                          "power.draw,temperature.gpu",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(fn, iters: int) -> float:
    """Time per call of ``iters`` back-to-back calls by CUDA events; it
    includes any gap in which the card waits for the host."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_windows(fn, iters: int, windows: int = 3):
    """The device events (``torch.profiler``) of ``windows`` windows of
    ``iters`` back-to-back calls of ``fn``, after one call to warm up."""
    fn()
    torch.cuda.synchronize()
    taken = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        taken.append(device_events(prof))
    return taken


def device_ms(fn, iters: int, counts=None) -> float:
    """Device time of ``fn`` per call: the time the card is busy with the
    kernels, copies and fills of ``iters`` calls, over ``iters``. Gaps in
    which the card waits for the host are not counted.

    The profiler now and then drops device events from a window (seen on
    the card: a window with none, another with about half), which reads as
    a shorter time. So three windows are profiled and only those with the
    most events count; if every window is empty, this raises. A drop that
    hits every window alike still reads short: ``launch_ms`` is robust to
    it where the kernels a call launches are known. ``counts``: a list that
    receives the windows' numbers of device events."""
    taken = profiled_windows(fn, iters)
    if counts is not None:
        counts.append([len(events) for events in taken])
    most = max(len(events) for events in taken)
    require(most > 0, "the profiler recorded no device events")
    kept = [events for events in taken if len(events) == most]
    return sum(busy_us(events) for events in kept) / len(kept) / 1e3 / iters


def launch_ms(fn, iters: int, names, parts=None, counts=None) -> float:
    """Device time per call of ``fn``, which launches each kernel named in
    ``names`` (by substring) once a call, one after the other, and nothing
    else on the card: the sum of the kernels' mean durations over three
    profiled windows of ``iters`` calls. Events the profiler drops leave the
    means as they are (in this script's process it recorded 35 of every
    window's 40 kNN kernels, where ``scripts/bench_knn_versions.py``
    records all 40, and the busy time of ``device_ms`` read 12-15% short).
    ``parts``: a dict that receives each kernel's ms; ``counts``: a list
    that receives the windows' numbers of device events."""
    taken = profiled_windows(fn, iters)
    if counts is not None:
        counts.append([len(events) for events in taken])
    ms = {n: us / 1e3 for n, us in mean_us(taken, names).items()}
    if parts is not None:
        parts.update(ms)
    return sum(ms.values())


def require(ok: bool, msg: str) -> None:
    """A check of the smoke run; unlike ``assert`` it also runs under -O."""
    if not ok:
        raise RuntimeError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_ulp(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    ulp = BF16_ULP if a.dtype == torch.bfloat16 else F32_ULP
    torch.testing.assert_close(a, b, rtol=ulp, atol=0, msg=lambda m: f"{what}: {m}")


def phase_kernels(dev) -> float:
    """Kernel against plain version on the full-width leaf set."""
    system = build_system(HIDDEN, HIDDEN, FEAT, device=dev)
    params0 = {n: p.detach().clone()
               for n, p in system.init_params(make_generator(1, dev)).items()}
    mask = topt.trainable_mask_fn(TRAINABLE)
    names = [n for n, on in mask(params0).items() if on]
    require(len(names) == 61, f"{len(names)} trainable leaves, not 61")
    worst = 0.0
    for moments in ("float32", "bfloat16"):
        runs = {}
        for impl in ("fused", "optax"):
            opt = topt.adam(LR, WD, trainable_mask=mask,
                            moments_dtype=moments, impl=impl)
            params = {n: p.clone() for n, p in params0.items()}
            state = opt.init(params)
            gen = make_generator(2, dev)
            for _ in range(3):
                grads = {n: torch.randn(params[n].shape, generator=gen,
                                        device=dev) for n in names}
                opt.apply(grads, state, params)
            runs[impl] = (params, state)
        torch.cuda.synchronize()
        (pk, sk), (pp, sp) = runs["fused"], runs["optax"]
        err = 0.0
        for n in params0:
            if n in names:
                for a, b, what in ((pk[n], pp[n], "p"), (sk.mu[n], sp.mu[n], "m"),
                                   (sk.nu[n], sp.nu[n], "v")):
                    check_ulp(a, b, f"{moments} {what} {n}")
                    err = max(err, max_err(a, b))
                require(not torch.equal(pk[n], params0[n]), f"{n} did not move")
            else:
                require(torch.equal(pk[n], params0[n])
                        and torch.equal(pp[n], params0[n]), f"frozen {n} moved")
        log(f"kernels: fused_adam vs plain, {moments} moments, 3 steps over "
            f"{len(names)} trainable + {len(params0) - len(names)} frozen "
            f"leaves: max_abs_err {err!r}")
        worst = max(worst, err)
    return worst


def knn_inputs(gen, t: int, m: int, p: int, f: int, valid):
    """Seeded normal features and bank on the card; masked bank rows are
    zeros, as a padded bank's are (0/0 if they were ever normalised)."""
    dev = gen.device
    feats = torch.randn((t, m, f), device=dev, generator=gen)
    bank = torch.randn((t, p, f), device=dev, generator=gen)
    if isinstance(valid, int):
        mask = (torch.arange(p, device=dev) < valid).expand(t, p).contiguous()
    else:
        mask = torch.rand((t, p), device=dev, generator=gen) < valid
    bank[~mask] = 0.0
    return feats, bank, mask


def knn_err(dist: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest distance difference over the entries finite in both."""
    ok = torch.isfinite(dist) & torch.isfinite(ref)
    return max_err(dist[ok], ref[ok])


def phase_knn_kernel(dev):
    """The kNN kernel against its plain version; returns (max_abs_err,
    near-tie swaps)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    worst, swaps = 0.0, 0
    for p, valid in KNN_CASES:
        feats, bank, mask = knn_inputs(gen, 3, 64, p, HIDDEN, valid)
        idx, dist = tkt.cosine_knn(feats, bank, mask, K)
        ref_idx, ref_dist = tkt.cosine_knn_reference(feats, bank, mask, K)
        torch.cuda.synchronize()
        require(not torch.isnan(dist).any(), f"P={p}: NaN distances")
        n = tkt.near_tie_swaps(idx, dist, ref_idx, ref_dist, KNN_TOL)
        err = knn_err(dist, ref_dist)
        log(f"kernels: cosine_knn vs plain, T=3 M=64 F={HIDDEN} k={K} P={p} "
            f"valid {int(mask[0].sum())}: max_abs_err {err!r}, near-tie "
            f"swaps {n}")
        worst, swaps = max(worst, err), swaps + n
    return worst, swaps


def snapshot(system):
    return {n: p.detach().clone() for n, p in system.params().items()}


def phase_train(dev, card: str):
    mtl = build_mtl_step(BATCH, FEAT, HIDDEN, impl="fused", device=dev)
    before = snapshot(mtl.system)
    tfa.fused_adam.launches = 0
    for _ in range(WARMUP):
        mtl(LR)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    logs = [mtl(LR) for _ in range(TIMED)]
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = tfa.fused_adam.launches
    step_ms = start.elapsed_time(end) / TIMED
    steps = WARMUP + TIMED
    require(launches >= steps,
            f"fused_adam launched {launches} times in {steps} steps")
    for i, l in enumerate(logs):
        for k, v in l.items():
            require(bool(torch.isfinite(v).all()), f"step {i}: {k} = {v}")
    after = snapshot(mtl.system)
    for n in before:
        frozen = n.startswith("task.oscc.")
        require(torch.equal(before[n], after[n]) == frozen,
                f"frozen {n} moved" if frozen else f"{n} did not move")
    last = {k: round(float(v), 6) for k, v in logs[-1].items()}
    log(f"train: {steps} steps, AR+LTA+PNR batch {BATCH} feat {FEAT} hidden "
        f"{HIDDEN}, fused Adam; last logs {json.dumps(last)}")
    log(f"train: {step_ms!r} ms/step (CUDA events over {TIMED} steps; host "
        f"{host_s / TIMED * 1e3!r} ms/step) on {card}")
    log(f"train: fused_adam launches {launches} in {steps} steps")

    # one step, dropout off, fused kernel against the plain Adam
    mtl.system.backbone.pooling.dropout = 0.0
    start_state = snapshot(mtl.system)
    params = mtl.system.params()
    outs = {}
    for impl in ("fused", "optax"):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start_state[n])
        opt = topt.adam(LR, WD, trainable_mask=topt.trainable_mask_fn(
            TRAINABLE), impl=impl)
        mtl.system.make_train_step(opt, ACTIVE)(opt.init(params),
                                                mtl.batches, None, LR)
        outs[impl] = snapshot(mtl.system)
    err = 0.0
    for n in outs["fused"]:
        a, b = outs["fused"][n], outs["optax"][n]
        torch.testing.assert_close(a, b, rtol=2 * F32_ULP, atol=1e-3 * LR,
                                   msg=lambda m: f"one step {n}: {m}")
        err = max(err, max_err(a, b))
    log(f"train: one step dropout off, fused vs plain Adam: max_abs_err "
        f"{err!r}")
    return mtl, step_ms, launches, steps


def phase_small_vs_cpu(dev) -> None:
    """A small model, three steps, on the card and on the CPU from the same
    weights and batches (the CPU path is the one held against JAX by the
    tests). Tolerance rtol 1e-4 / atol 1e-5."""
    tol = dict(rtol=1e-4, atol=1e-5)
    cpu = build_mtl_step(2, 16, 32, tp_dropout=0.0, device="cpu")
    gpu = build_mtl_step(2, 16, 32, tp_dropout=0.0, device=dev)
    # the two generators draw different weights: carry the CPU's across
    gpu.system.load_state({k: v.to(dev) for k, v in
                           cpu.system.model.state_dict().items()})
    for step in range(3):
        lc, lg = cpu(1e-3), gpu(1e-3)
        for k in lc:
            torch.testing.assert_close(lg[k].cpu(), lc[k], **tol,
                                       msg=lambda m: f"step {step} {k}: {m}")
    pc, pg = snapshot(cpu.system), snapshot(gpu.system)
    for n in pc:
        torch.testing.assert_close(pg[n].cpu(), pc[n], **tol)
    log("train: small model, 3 steps, card against CPU: losses, norms and "
        "parameters agree (rtol 1e-4, atol 1e-5)")


def driver_overrides(root: str, tmp: str, epochs: int):
    """The README's phase-1 command on the fixture, at full width."""
    return ["k=1", "batch_size=16", "model.hidden_size=1024",
            "model.temporal_pooling.hidden_size=1024",
            "model.temporal_pooling.dropout=0.5", "enabled_tasks=[ar,lta,pnr]",
            "optimizer.impl=fused", "save_model=True", "checkpoint.enable=True",
            f"num_epochs={epochs}", "validation_split=val",
            f"dataset_recognition.root={root}", f"dataset_oscc.root={root}",
            f"dataset_lta.root={root}", f"dataset_pnr.root={root}",
            f"artifact_dir={tmp}/artifacts", f"output_dir={tmp}/outputs",
            f"checkpoint.dir={tmp}/checkpoints"]


def phase_driver(tmp: str, card: str):
    """The phase-1 CLI at full width; returns (the artifact's torch state,
    fused_adam launches, optimizer steps, ms per step over epochs 2-3)."""
    t0 = time.perf_counter()
    root = generate_ego4d_fixture(f"{tmp}/ego4d", feature_dim=FEAT,
                                  n_videos=DRIVER_VIDEOS, n_verbs=N_VERBS,
                                  n_nouns=N_NOUNS, n_oscc=DRIVER_OSCC,
                                  learnable=True)
    log(f"driver: fixture of {DRIVER_VIDEOS} videos, feature_dim {FEAT}, "
        f"{N_VERBS} verbs, {N_NOUNS} nouns "
        f"({time.perf_counter() - t0:.1f} s)")
    tfa.fused_adam.launches = 0
    calls0 = dict(native.PATH_CALLS)
    t0 = time.perf_counter()
    result = train_main(driver_overrides(root, tmp, DRIVER_EPOCHS))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = tfa.fused_adam.launches
    stats = result["epochs"]
    steps = sum(s["steps"] for s in stats)
    require([s["epoch"] for s in stats] == list(range(1, DRIVER_EPOCHS + 1)),
            f"epochs run: {stats}")
    require(launches == steps and steps > 0,
            f"fused_adam launched {launches} times in {steps} optimizer steps")
    gathers = {k: native.PATH_CALLS[k] - calls0[k] for k in calls0}
    require(gathers["native"] > 0 and gathers["numpy"] == 0,
            f"feature gathers by path: {gathers}")
    with open(f"{result['run_dir']}/metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r for r in records if "train/ar/loss" in r]
    require(len(losses) == DRIVER_EPOCHS, f"{len(losses)} epoch records")
    for r in losses:
        for k, v in r.items():
            if k.startswith("train/"):
                require(math.isfinite(v), f"epoch {r['step']}: {k} = {v}")
    val = result["val_metrics"]
    require(sorted(val) == ["ar", "lta", "pnr"],
            f"meter blocks for {sorted(val)}")
    require(0.0 <= val["lta"]["verbs_ed"] <= 1.0
            and 0.0 <= val["ar"]["verbs_top1"] <= 1.0, f"metrics {val}")
    payload, meta = load_artifact(f"{tmp}/artifacts", ARTIFACT)
    require(int(payload.pop("epoch")) == DRIVER_EPOCHS
            and meta == {"tasks": list(ACTIVE), "num_epochs": DRIVER_EPOCHS},
            f"artifact meta {meta}")
    state = interop.from_flax(payload)
    params = result["system"].params()
    require(sorted(state) == sorted(params), "artifact leaves differ")
    for n, v in state.items():
        require(torch.equal(v, params[n].detach().cpu()),
                f"artifact leaf {n} differs from the trained parameter")
    timed = [s for s in stats if s["epoch"] >= 2]
    ms_step = (sum(s["train_s"] for s in timed)
               / sum(s["steps"] for s in timed) * 1e3)
    last = {k: round(v, 6) for k, v in losses[-1].items()
            if k.startswith("train/")}
    log(f"driver: {DRIVER_EPOCHS} epochs, {steps} optimizer steps in "
        f"{run_s:.1f} s; last epoch {json.dumps(last)}; validation AR verbs "
        f"top-1 {val['ar']['verbs_top1']!r}, LTA verbs ED "
        f"{val['lta']['verbs_ed']!r}, PNR localization error "
        f"{val['pnr']['localization_error']!r}")
    log(f"driver: fused_adam launches {launches} in {steps} optimizer steps; "
        f"feature gathers {json.dumps(gathers)}; artifact {ARTIFACT} read "
        f"back equal to the trained parameters ({len(state)} leaves)")
    log(f"driver: {ms_step!r} ms per optimizer step over epochs 2-"
        f"{DRIVER_EPOCHS} (wall clock, data loading included; "
        f"{[round(s['train_s'], 3) for s in timed]} s for "
        f"{[s['steps'] for s in timed]} steps) on {card}")
    again = train_main(driver_overrides(root, tmp, DRIVER_EPOCHS + 1))
    require(again["start_epoch"] == DRIVER_EPOCHS + 1
            and [s["epoch"] for s in again["epochs"]] == [DRIVER_EPOCHS + 1],
            f"the second call started at epoch {again['start_epoch']}")
    log(f"driver: a second call with num_epochs={DRIVER_EPOCHS + 1} resumed "
        f"at epoch {again['start_epoch']} from the full-state checkpoint")
    del result, again
    payload, _ = load_artifact(f"{tmp}/artifacts", ARTIFACT)
    payload.pop("epoch")
    return interop.from_flax(payload), launches, steps, ms_step


def egopack_overrides(root: str, tmp: str, epochs: int):
    """Novel OSCC from the driver's artifact at full width (GraphONE k=8,
    depth 3, hidden 1024, no residual; fused Adam at 1e-6; head dropout
    0.5; backbone trained in eval mode; late fusion)."""
    return ["k=1", "batch_size=16", "model.hidden_size=1024",
            "model.temporal_pooling.hidden_size=1024", "enabled_tasks=[oscc]",
            "enable_graphone=True", f"resume_from={ARTIFACT}", "graphone.k=8",
            "graphone.depth=3", "graphone.hidden_size=1024",
            "graphone.residual=False", "optimizer.impl=fused",
            "optimizer.lr=1e-6", "task_head_dropout=0.5",
            "backprop_temporal_graph=True", "temporal_graph_train_mode=False",
            "late_fusion=True", "save_model=True", "checkpoint.enable=True",
            f"num_epochs={epochs}", "validation_split=val",
            f"dataset_recognition.root={root}", f"dataset_oscc.root={root}",
            f"dataset_lta.root={root}", f"dataset_pnr.root={root}",
            f"artifact_dir={tmp}/artifacts",
            f"output_dir={tmp}/outputs_egopack",
            f"checkpoint.dir={tmp}/checkpoints"]


def phase_egopack_driver(tmp: str, card: str) -> dict:
    """The phase-2 CLI at full width from the driver phase's artifact;
    returns its launch counts, steps, times and the last OSCC
    validation."""
    t0 = time.perf_counter()
    root = generate_ego4d_fixture(f"{tmp}/ego4d_oscc", feature_dim=FEAT,
                                  n_videos=DRIVER_VIDEOS, n_verbs=N_VERBS,
                                  n_nouns=N_NOUNS, n_oscc=EGOPACK_OSCC,
                                  learnable=True)
    log(f"egopack_driver: fixture of {DRIVER_VIDEOS} videos and "
        f"{EGOPACK_OSCC} OSCC windows a split, feature_dim {FEAT} "
        f"({time.perf_counter() - t0:.1f} s)")
    tfa.fused_adam.launches = 0
    tkt.cosine_knn.launches = 0
    t0 = time.perf_counter()
    result = egopack_main(egopack_overrides(root, tmp, DRIVER_EPOCHS))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    adam_launches = tfa.fused_adam.launches
    knn_launches = tkt.cosine_knn.launches
    stats = result["epochs"]
    steps = sum(s["steps"] for s in stats)
    val_batches = len(result["dsets"]["oscc"]["dl_val"])
    require([s["epoch"] for s in stats] == list(range(1, DRIVER_EPOCHS + 1)),
            f"epochs run: {stats}")
    require(adam_launches == steps and steps > 0,
            f"fused_adam launched {adam_launches} times in {steps} "
            "optimizer steps")
    require(knn_launches == steps + val_batches * DRIVER_EPOCHS,
            f"cosine_knn launched {knn_launches} times for {steps} optimizer "
            f"steps and {val_batches} OSCC validation batches in each of "
            f"{DRIVER_EPOCHS} epochs")
    with open(f"{result['run_dir']}/metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r for r in records if "train/oscc/loss" in r]
    require(len(losses) == DRIVER_EPOCHS, f"{len(losses)} epoch records")
    for r in losses:
        for k, v in r.items():
            if k.startswith("train/"):
                require(math.isfinite(v), f"epoch {r['step']}: {k} = {v}")
    val = result["val_metrics"]
    require(sorted(val) == ["oscc"]
            and 0.0 <= val["oscc"]["accuracy"] <= 1.0
            and math.isfinite(val["oscc"]["loss"]), f"meter blocks {val}")
    payload, meta = load_artifact(f"{tmp}/artifacts", EGOPACK_ARTIFACT)
    require(meta.get("phase") == "egopack"
            and meta.get("aux_tasks") == list(AUX_TASKS)
            and meta.get("tasks") == ["oscc"], f"artifact meta {meta}")
    banks = result["banks"]
    for t, b in banks.items():
        require(torch.equal(torch.tensor(payload["graphone_banks"][t]),
                            b.values.cpu())
                and torch.equal(torch.tensor(payload["graphone_bank_masks"][t]),
                                b.mask.cpu()),
                f"artifact bank {t} differs from the bank built")
    timed = [s for s in stats if s["epoch"] >= 2]
    ms_step = (sum(s["train_s"] for s in timed)
               / sum(s["steps"] for s in timed) * 1e3)
    data_ms = (sum(s["data_s"] for s in timed)
               / sum(s["steps"] for s in timed) * 1e3)
    bank = banks["ar"]
    last = {k: round(v, 6) for k, v in losses[-1].items()
            if k.startswith("train/")}
    log(f"egopack_driver: banks of {bank.num_valid} prototypes (P_pad "
        f"{bank.values.shape[0]}) built in {result['sweep_s']!r} s; "
        f"{DRIVER_EPOCHS} epochs, {steps} optimizer steps in {run_s:.1f} s; "
        f"last epoch {json.dumps(last)}; OSCC accuracy "
        f"{val['oscc']['accuracy']!r}, loss {val['oscc']['loss']!r}")
    log(f"egopack_driver: fused_adam launches {adam_launches} in {steps} "
        f"optimizer steps; cosine_knn launches {knn_launches} = {steps} "
        f"steps + {val_batches} OSCC validation batches x {DRIVER_EPOCHS} "
        f"epochs; artifact {EGOPACK_ARTIFACT} banks and masks equal to the "
        f"banks built")
    log(f"egopack_driver: {ms_step!r} ms per optimizer step over epochs 2-"
        f"{DRIVER_EPOCHS} (wall clock, data loading included; "
        f"{[round(s['train_s'], 3) for s in timed]} s for "
        f"{[s['steps'] for s in timed]} steps), of which {data_ms!r} ms "
        f"waiting for data ({[round(s['data_s'], 3) for s in timed]} s); "
        f"prototype sweep {result['sweep_s']!r} s; on {card}")
    again = egopack_main(egopack_overrides(root, tmp, DRIVER_EPOCHS + 1))
    require(again["start_epoch"] == DRIVER_EPOCHS + 1
            and [s["epoch"] for s in again["epochs"]] == [DRIVER_EPOCHS + 1],
            f"the second call started at epoch {again['start_epoch']}")
    log(f"egopack_driver: a second call with num_epochs={DRIVER_EPOCHS + 1} "
        f"resumed at epoch {again['start_epoch']} from the full-state "
        f"checkpoint (sweep {again['sweep_s']!r} s)")
    return {"root": root, "adam_launches": adam_launches,
            "knn_launches": knn_launches, "steps": steps,
            "val_batches": val_batches, "ms_step": ms_step,
            "data_ms": data_ms, "sweep_s": result["sweep_s"],
            "last_val": again["val_metrics"]["oscc"]}


def phase_evaluate(tmp: str, ego: dict) -> int:
    """``egopack_torch.evaluate`` cold on the phase-2 artifact; returns its
    kNN launches."""
    tfa.fused_adam.launches = 0
    tkt.cosine_knn.launches = 0
    out = f"{tmp}/metrics.json"
    overrides = [o for o in egopack_overrides(ego["root"], tmp, 1)
                 if not o.startswith("resume_from=")]
    metrics = evaluate_main(overrides + [f"resume_from={EGOPACK_ARTIFACT}",
                                         f"output={out}"])
    torch.cuda.synchronize()
    knn_launches = tkt.cosine_knn.launches
    require(knn_launches == ego["val_batches"]
            and tfa.fused_adam.launches == 0,
            f"evaluate launched cosine_knn {knn_launches} times for "
            f"{ego['val_batches']} validation batches")
    with open(out) as f:
        written = json.load(f)
    cold, last = metrics["oscc"], ego["last_val"]
    require(sorted(metrics) == ["oscc"] and written == metrics,
            f"evaluate metrics {metrics}")
    require(cold["accuracy"] == last["accuracy"]
            and math.isclose(cold["loss"], last["loss"], rel_tol=1e-5),
            f"cold OSCC {cold} against the driver's last validation {last}")
    log(f"evaluate: {EGOPACK_ARTIFACT} cold: OSCC accuracy "
        f"{cold['accuracy']!r}, loss {cold['loss']!r} (the driver's last "
        f"validation: {last['accuracy']!r}, {last['loss']!r}); cosine_knn "
        f"launches {knn_launches} in {ego['val_batches']} validation batches")
    return knn_launches


def phase_numbers(mtl, dev, card: str) -> dict:
    """The kernel (f32 and bf16 moments), the plain version and the library
    call on the same full-width trainable tensors, each timed twice in turns
    (one order, then the reverse) and two ways: the arm's own time on the
    card (``launch_ms`` for the kernel, ``device_ms`` for the others), and
    ``time_ms``, which also counts the gaps in which the card waits for the
    host to launch the next kernel."""
    params = mtl.system.params()
    names = mtl.optimizer.trainable_names(params)
    numel = sum(params[n].numel() for n in names)
    gen = make_generator(3, dev)
    grads = {n: torch.randn(params[n].shape, generator=gen, device=dev)
             for n in names}
    arms = {}
    for arm, impl, moments in (("plain", "optax", "float32"),
                               ("fused", "fused", "float32"),
                               ("fused_bf16", "fused", "bfloat16")):
        opt = topt.adam(LR, WD, moments_dtype=moments, impl=impl)
        p = {n: params[n].detach().clone() for n in names}
        st = opt.init(p)
        arms[arm] = (lambda o=opt, s=st, q=p: o.apply(grads, s, q))
    lib_params = [params[n].detach().clone() for n in names]
    for q, n in zip(lib_params, names):
        q.grad = grads[n].clone()
    lib = torch.optim.Adam(lib_params, lr=LR, weight_decay=WD, fused=True)
    arms["library"] = lib.step
    dev_runs = {k: [] for k in arms}
    gap_runs = {k: [] for k in arms}
    counts = {k: [] for k in arms}
    order = ("plain", "fused", "library", "fused_bf16")
    for seq in (order, order[::-1]):
        for k in seq:
            if k.startswith("fused"):  # one kernel launch a step
                dev_runs[k].append(launch_ms(arms[k], 30, ("adam_kernel",),
                                             counts=counts[k]))
            else:
                dev_runs[k].append(device_ms(arms[k], 30, counts[k]))
            gap_runs[k].append(time_ms(arms[k], 30))
    ms = {k: sum(v) / len(v) for k, v in dev_runs.items()}
    gap_ms = {k: sum(v) / len(v) for k, v in gap_runs.items()}
    launches0 = tfa.fused_adam.launches
    arms["fused"]()
    per_call = tfa.fused_adam.launches - launches0
    rate = hbm_bytes_per_s(card)
    bound_bytes_ms = 28 * numel / rate * 1e3
    bound_ops_ms = ADAM_FLOPS_PER_ELEM * numel / fp32_peak(card) * 1e3
    log(f"numbers: {numel} trainable elements in {len(names)} leaves, "
        f"fused_adam {per_call} launch(es) per step; device ms per step "
        f"(torch.profiler; the kernel by its mean duration): fused_adam "
        f"{ms['fused']!r}, bf16 moments "
        f"{ms['fused_bf16']!r}, plain {ms['plain']!r}, "
        f"torch.optim.Adam(fused=True) {ms['library']!r}; bound "
        f"{bound_bytes_ms!r} (28 B/elem), bf16 {20 * numel / rate * 1e3!r} "
        f"(20 B/elem) at {rate:.3g} B/s; on {card}")
    log(f"numbers: with launch gaps (CUDA events) ms per step: fused_adam "
        f"{gap_ms['fused']!r}, bf16 moments {gap_ms['fused_bf16']!r}, plain "
        f"{gap_ms['plain']!r}, library {gap_ms['library']!r}; on {card}")
    log(f"numbers: runs device {json.dumps(dev_runs)}; with gaps "
        f"{json.dumps(gap_runs)}; device events in each profiled window "
        f"{json.dumps(counts)}")
    return {"ms": ms["fused"], "plain_ms": ms["plain"],
            "library_ms": ms["library"],
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
            else "operations"}


def secondary_features(ego):
    """The kNN inputs of the EgoPack step on its batch: the aux heads'
    projections of the OSCC backbone features, stacked over the tasks."""
    system = ego.system
    with torch.no_grad():
        feat, _ = system.backbone_features(ego.batches["oscc"], "oscc", False,
                                           None)
        flat = feat.reshape(-1, feat.shape[-1])
        return torch.stack([system.tasks[t].head.forward_features(flat)
                            for t in AUX_TASKS])


def restore(ego, params0, state0) -> None:
    with torch.no_grad():
        for n, p in ego.system.params().items():
            p.copy_(params0[n])
        for mine, saved in ((ego.opt_state.mu, state0.mu),
                            (ego.opt_state.nu, state0.nu)):
            for n in mine:
                mine[n].copy_(saved[n])
    ego.opt_state.count = state0.count


def phase_egopack(mtl, loaded, dev, card: str):
    """Phase 1 -> phase 2 at full width, from the phase-1 driver's
    artifact (``loaded``, a torch state)."""
    t0 = time.perf_counter()
    proto = [synthetic_batches(mtl.system, PROTO_BATCH, FEAT, seed=100 + i,
                               names=("ar",))["ar"]
             for i in range(PROTO_BATCHES)]
    ego = build_egopack_step(BATCH, FEAT, HIDDEN,
                             loaded=loaded,
                             proto_batches=proto, device=dev)
    del proto
    bank = ego.banks["ar"]
    p_pad, n_valid = bank.values.shape[0], bank.num_valid
    log(f"egopack: phase-2 system with the artifact's phase-1 state merged "
        f"in; banks "
        f"from {PROTO_BATCHES} AR batches of {PROTO_BATCH} clips: num_valid "
        f"{n_valid}, P_pad {p_pad} ({time.perf_counter() - t0:.1f} s)")
    params = ego.system.params()
    trainable = set(ego.optimizer.trainable_names(params))
    require(len(trainable) == 53, f"{len(trainable)} trainable leaves, not 53")
    log(f"egopack: {len(trainable)} trainable leaves, "
        f"{sum(params[n].numel() for n in trainable)} elements")
    before = snapshot(ego.system)
    banks0 = {t: b.values.clone() for t, b in ego.banks.items()}

    tfa.fused_adam.launches = 0
    tkt.cosine_knn.launches = 0
    for _ in range(WARMUP):
        ego(LR_EGO)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    logs = [ego(LR_EGO) for _ in range(TIMED)]
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    knn_launches = tkt.cosine_knn.launches
    adam_launches = tfa.fused_adam.launches
    steps = WARMUP + TIMED
    step_ms = start.elapsed_time(end) / TIMED
    require(knn_launches == steps and adam_launches == steps,
            f"{knn_launches} kNN and {adam_launches} fused_adam launches in "
            f"{steps} steps, not one each per step")
    for i, l in enumerate(logs):
        for k, v in l.items():
            require(bool(torch.isfinite(v).all()), f"step {i}: {k} = {v}")
    after = snapshot(ego.system)
    for n in before:
        if n in trainable:
            require(not torch.equal(before[n], after[n]), f"{n} did not move")
        else:
            require(torch.equal(before[n], after[n]), f"frozen {n} moved")
    for t, b in ego.banks.items():
        require(torch.equal(b.values, banks0[t]), f"bank {t} changed")
    last = {k: round(float(v), 6) for k, v in logs[-1].items()}
    log(f"egopack: {steps} steps, novel OSCC batch {BATCH}, aux "
        f"{'+'.join(AUX_TASKS)}, GraphONE depth 3 k={K}, fused Adam; last "
        f"logs {json.dumps(last)}")
    log(f"egopack: {step_ms!r} ms/step (CUDA events over {TIMED} steps; host "
        f"{host_s / TIMED * 1e3!r} ms/step) on {card}")
    log(f"egopack: cosine_knn launches {knn_launches}, fused_adam launches "
        f"{adam_launches} in {steps} steps")

    # one step with the plain kNN from the same state
    feats = secondary_features(ego)
    masks = torch.stack([ego.banks[t].mask for t in AUX_TASKS])
    values = torch.stack([ego.banks[t].values for t in AUX_TASKS])
    idx, dist = prototype_topk(feats, values, masks, K, impl="cuda")
    ref_idx, ref_dist = prototype_topk(feats, values, masks, K, impl="plain")
    swaps = tkt.near_tie_swaps(idx, dist, ref_idx, ref_dist, KNN_TOL)
    params0 = snapshot(ego.system)
    state0 = topt.AdamState(dict(ego.opt_state.hyperparams),
                            ego.opt_state.count,
                            {n: v.clone() for n, v in ego.opt_state.mu.items()},
                            {n: v.clone() for n, v in ego.opt_state.nu.items()})
    outs, losses = {}, {}
    for impl in ("auto", "plain"):
        restore(ego, params0, state0)
        ego.graphone.knn_impl = impl
        losses[impl] = ego(LR_EGO)["oscc_loss"]
        outs[impl] = snapshot(ego.system)
    ego.graphone.knn_impl = "auto"
    err = 0.0
    if swaps == 0:
        torch.testing.assert_close(losses["auto"], losses["plain"],
                                   rtol=1e-5, atol=1e-6)
        for n in outs["auto"]:
            a, b = outs["auto"][n], outs["plain"][n]
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                       msg=lambda m: f"one step {n}: {m}")
            err = max(err, max_err(a, b))
    log(f"egopack: the step's kNN, kernel vs plain: near-tie swaps {swaps}, "
        f"max_abs_err {knn_err(dist, ref_dist)!r}; one step kernel vs plain "
        f"kNN: " + (f"losses {float(losses['auto'])!r} and "
                    f"{float(losses['plain'])!r}, parameters max_abs_err "
                    f"{err!r}" if swaps == 0 else
                    "not compared (the neighbours differ at a near-tie)"))

    eval_step = ego.system.make_eval_step("oscc", aux=AUX_TASKS,
                                          graphone=ego.graphone,
                                          late_fusion=True)
    logits, per_elem, post, _ = eval_step(ego.batches["oscc"], ego.banks)
    require(tuple(logits.shape) == (BATCH, 2)
            and bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(per_elem).all()),
            f"eval logits {logits}")
    log(f"egopack: eval step OSCC, GraphONE + late fusion: logits "
        f"{tuple(logits.shape)} finite, post features {tuple(post.shape)}")
    feats_m = (feats, values, masks)
    return ego, step_ms, knn_launches, steps, feats_m


def phase_small_egopack_vs_cpu(dev) -> None:
    """A small phase-2 model, three steps, on the card (kNN kernel) and on
    the CPU (plain kNN) from the same weights, banks and batches.
    Tolerance rtol 1e-4 / atol 1e-5."""
    tol = dict(rtol=1e-4, atol=1e-5)
    cpu = build_egopack_step(2, 16, 32, p_pad=128, fill=100, device="cpu")
    gpu = build_egopack_step(2, 16, 32, p_pad=128, fill=100, device=dev)
    gpu.system.load_state({k: v.to(dev) for k, v in
                           cpu.system.model.state_dict().items()})
    for t in cpu.banks:
        require(torch.equal(gpu.banks[t].values.cpu(), cpu.banks[t].values),
                f"small banks differ for {t}")
    launches = tkt.cosine_knn.launches
    for step in range(3):
        lc, lg = cpu(1e-3), gpu(1e-3)
        for k in lc:
            torch.testing.assert_close(lg[k].cpu(), lc[k], **tol,
                                       msg=lambda m: f"step {step} {k}: {m}")
    require(tkt.cosine_knn.launches - launches == 3,
            "the small model on the card did not launch the kNN kernel")
    pc, pg = snapshot(cpu.system), snapshot(gpu.system)
    for n in pc:
        torch.testing.assert_close(pg[n].cpu(), pc[n], **tol)
    log("egopack: small model, 3 steps, card (kNN kernel) against CPU (plain "
        "kNN): losses, norms and parameters agree (rtol 1e-4, atol 1e-5)")


def knn_bound(feats, mask, k: int, card: str):
    """Least time for the kNN on these inputs, whatever kernel computes it:
    the larger of the bytes (each valid bank row, the features and the mask
    read once, the (idx, dist) output written once) over the memory rate,
    and the products with the valid bank rows (2*M*F flops each) as
    float32-accurate products at the tensor cores' TF32 peak. One such
    product costs three TF32 products (3xTF32: hi and lo halves of each
    operand), so the flops count three times: 165 TFLOP/s of such products
    on the H100 SXM, against 67 on its CUDA cores (``fp32_peak``)."""
    t, m, f = feats.shape
    valid = int(mask.sum())
    flops = 2 * m * f * valid
    nbytes = 4 * (valid * f + t * m * f) + mask.numel() + 8 * t * m * k
    ops_ms = 3 * flops / tf32_peak(card) * 1e3
    bytes_ms = nbytes / hbm_bytes_per_s(card) * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), flops, nbytes


def phase_knn_numbers(main_inputs, dev, card: str) -> dict:
    """Kernel, plain version and library call on the main path's kNN inputs
    and on a full-taxonomy bank (P=55,040), each timed twice in turns by
    the profiler (the kernel by ``launch_ms``, the others by
    ``device_ms``), with the card's clocks, power and temperature read
    before and after each window and the windows' event counts."""
    gen = torch.Generator(device=dev).manual_seed(9)
    shapes = {"main": main_inputs,
              "full": knn_inputs(gen, 3, 64, 55040, HIDDEN, 50000)}

    def library(feats, bank, mask):
        d = 1.0 - torch.bmm(torch.nn.functional.normalize(feats, dim=-1),
                            torch.nn.functional.normalize(bank, dim=-1)
                            .transpose(1, 2))
        return torch.topk(torch.where(mask[:, None, :], d, torch.inf), K,
                          largest=False)

    out = {}
    for key, (feats, bank, mask) in shapes.items():
        arms = {"kernel": lambda: tkt.cosine_knn(feats, bank, mask, K),
                "plain": lambda: tkt.cosine_knn_reference(feats, bank, mask,
                                                          K),
                "library": lambda: library(feats, bank, mask)}
        runs = {a: [] for a in arms}
        clocks = {a: [] for a in arms}
        counts = {a: [] for a in arms}
        passes = {n: [] for n in KNN_PASSES}
        order = ("plain", "kernel", "library")
        for seq in (order, order[::-1]):
            for a in seq:
                before = gpu_clocks()
                if a == "kernel":
                    parts = {}
                    runs[a].append(launch_ms(arms[a], 20, KNN_PASSES, parts,
                                             counts[a]))
                    for n in KNN_PASSES:
                        passes[n].append(parts[n])
                else:
                    runs[a].append(device_ms(arms[a], 20, counts[a]))
                clocks[a].append([before, gpu_clocks()])
        ms = {a: sum(v) / len(v) for a, v in runs.items()}
        passes = {n: sum(v) / len(v) for n, v in passes.items()}
        bound, by, flops, nbytes = knn_bound(feats, mask, K, card)
        log(f"numbers: cosine_knn T={feats.shape[0]} M={feats.shape[1]} "
            f"F={feats.shape[2]} P={bank.shape[1]} ({int(mask.sum())} valid) "
            f"k={K}: device ms per call (torch.profiler; the kernel by its "
            f"passes' mean durations) kernel "
            f"{ms['kernel']!r}, plain {ms['plain']!r}, torch.topk over masked "
            f"1-bmm {ms['library']!r}; bound {bound!r} by {by} ({flops} "
            f"flop, {nbytes} B); runs {json.dumps(runs)}; the kernel's "
            f"passes {json.dumps(passes)}; on {card}")
        log(f"numbers: cosine_knn P={bank.shape[1]} SM and memory clocks, "
            f"power draw, temperature before and after each window of runs: "
            f"{json.dumps(clocks)}; device events in each profiled window: "
            f"{json.dumps(counts)}")
        out[key] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                    "library_ms": ms["library"], "bound_ms": bound,
                    "bound_by": by}
    return out


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "tflops", "mfu"}
BENCH_METRICS = ("ego4d_mtl_clips_per_sec_per_chip_fwd_bwd",
                 "ego4d_egopack_oscc_clips_per_sec_per_chip_fwd_bwd")
BENCH_SPC, BENCH_WINDOWS = 8, 2


def phase_bench(card: str) -> dict:
    """``python -m egopack_torch.bench`` at full width and its defaults but
    ``steps_per_call`` and the windows, in a process of its own; then the
    launches of one call of each line, counted in this process at the same
    settings."""
    from egopack_torch import bench
    env = dict(os.environ, BENCH_WINDOWS=str(BENCH_WINDOWS),
               BENCH_STEPS_PER_CALL=str(BENCH_SPC))
    for knob in ("BENCH_DTYPE", "BENCH_BF16_PROP", "BENCH_SKIP_EGOPACK",
                 "BENCH_PEAK_TFLOPS", "BENCH_FEAT_DIM", "BENCH_HIDDEN",
                 "BENCH_BATCH", "BENCH_DEVICE", "BENCH_LOG_NORMS",
                 "BENCH_MOMENTS_DTYPE", "EGOPACK_FUSED_LAYOUT"):
        env.pop(knob, None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "egopack_torch.bench"],
                          cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=600)
    run_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = [json.loads(l) for l in proc.stdout.splitlines()
             if l.startswith("{")]
    require([l.get("metric") for l in lines] == list(BENCH_METRICS),
            f"bench printed {proc.stdout}")
    for line in lines:
        require(set(line) == BENCH_KEYS and line["unit"] == "clips/s/chip"
                and line["value"] > 0 and line["tflops"] > 0
                and 0 < line["mfu"] < 1, f"bench line {line}")
    for line in proc.stdout.splitlines():
        log(f"bench: {line}")
    log(f"bench: the command took {run_s:.1f} s (steps_per_call "
        f"{BENCH_SPC}, {BENCH_WINDOWS} windows) on {card}")

    counts = {}
    for name, build, lr in (("mtl", bench.build_mtl_step, bench.LR_MTL),
                            ("egopack", bench.build_egopack_step,
                             bench.LR_EGOPACK)):
        step = build(BENCH_SPC)
        step(lr)  # builds the layout constants
        torch.cuda.synchronize()
        tfa.fused_adam.launches = 0
        tkt.cosine_knn.launches = 0
        step(lr)
        torch.cuda.synchronize()
        counts[name] = (tfa.fused_adam.launches, tkt.cosine_knn.launches)
        del step
    want = {"mtl": (BENCH_SPC, 0), "egopack": (BENCH_SPC, BENCH_SPC)}
    require(counts == want, f"launches of one bench call {counts}, "
            f"expected {want} (fused_adam, cosine_knn)")
    (adam1, _), (adam2, knn2) = counts["mtl"], counts["egopack"]
    log(f"bench: one call of {BENCH_SPC} steps launches fused_adam {adam1} "
        f"times in line 1; fused_adam {adam2} and cosine_knn {knn2} times in "
        "line 2")
    return {"lines": lines, "adam": counts["mtl"][0] + counts["egopack"][0],
            "knn": counts["egopack"][1]}


GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul")


def gemm_kernels(prof, path: str) -> dict:
    """The kernels launched by matrix products in a ``torch.profiler``
    trace recorded with ``record_shapes``, keyed by (the op's first operand
    type, its first two operands' shapes, kernel name): [launches, device
    us]. The exported Chrome trace ties each kernel to its op by the op's
    external id."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = {}
    for e in events:
        args = e.get("args", {})
        if e.get("cat") == "cpu_op" and e.get("name") in GEMM_OPS \
                and "External id" in args:
            ops[args["External id"]] = (
                args.get("Input type", ["?"])[0],
                json.dumps(args.get("Input Dims", [])[:2]))
    out: dict = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ext = e.get("args", {}).get("External id")
        if ext in ops:
            entry = out.setdefault(ops[ext] + (e["name"],), [0, 0.0])
            entry[0] += 1
            entry[1] += float(e.get("dur", 0.0))
    return out


def profile_step(step, lr: float, path: str):
    """One warm step, then one step under ``torch.profiler`` (CPU and CUDA,
    shapes recorded): (GEMM kernels by operand type, device busy ms, the
    idle share of the span from the step's first kernel to its last, device
    events, the top kernels by device ms)."""
    step(lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(lr)
        torch.cuda.synchronize()
    events = device_events(prof)
    require(bool(events), "the profiler recorded no device events")
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    busy = busy_us(events)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return gemm_kernels(prof, path), busy / 1e3, 1.0 - busy / span, \
        len(events), top


def loss_gap(a: dict, b: dict, key: str) -> float:
    return abs(float(a[key]) - float(b[key])) / abs(float(b[key]))


def phase_bf16(dev, card: str, tmp: str) -> None:
    """bf16 compute and bf16 propagation at full width against float32
    from the same state, small models against the CPU, and the GEMM
    kernels of the bf16 step."""
    # full width: one step of each phase, dropout off, seeded alike
    gaps = {}
    for name, kw in (("compute_dtype=bfloat16",
                      {"compute_dtype": torch.bfloat16}),
                     ("propagate_dtype=bfloat16",
                      {"propagate_dtype": torch.bfloat16})):
        ref = build_mtl_step(BATCH, FEAT, HIDDEN, tp_dropout=0.0, device=dev)
        l32 = ref(LR)
        ours = build_mtl_step(BATCH, FEAT, HIDDEN, tp_dropout=0.0,
                              device=dev, **kw)
        l16 = ours(LR)
        del ref, ours
        e32 = build_egopack_step(BATCH, FEAT, HIDDEN, device=dev)(LR_EGO)
        e16 = build_egopack_step(BATCH, FEAT, HIDDEN, device=dev,
                                 **kw)(LR_EGO)
        torch.cuda.synchronize()
        g = {f"phase1 {k}": loss_gap(l16, l32, k)
             for k in ("ar_loss", "lta_loss", "pnr_loss")}
        g["phase2 oscc_loss"] = loss_gap(e16, e32, "oscc_loss")
        # bf16 operands carry 8 significant bits: within 2**-5 of float32
        # after the few layers between the inputs and a loss
        require(all(math.isfinite(v) and v < 2.0 ** -5 for v in g.values()),
                f"{name}: relative loss gaps to float32 {g}")
        gaps[name] = g
        log(f"bf16: {name}, one step at full width from the float32 step's "
            f"state: relative loss gaps to float32 {json.dumps(g)}")

    # small models, card against CPU: with bf16 compute only the first
    # product takes bf16 operands, whose products are exact, so float32
    # tolerances; with bf16 propagation a bf16 rounding may fall the other
    # way, so losses within one bf16 unit and parameters within 2 lr a step
    for name, kw, loss_tol, param_atol in (
            ("compute_dtype=bfloat16", {"compute_dtype": torch.bfloat16},
             dict(rtol=1e-4, atol=1e-5), 1e-5),
            ("propagate_dtype=bfloat16", {"propagate_dtype": torch.bfloat16},
             dict(rtol=2.0 ** -7, atol=1e-5), 3 * 2 * 1e-3)):
        cpu = build_mtl_step(2, 16, 32, tp_dropout=0.0, device="cpu", **kw)
        gpu = build_mtl_step(2, 16, 32, tp_dropout=0.0, device=dev, **kw)
        gpu.system.load_state({k: v.to(dev) for k, v in
                               cpu.system.model.state_dict().items()})
        for step in range(3):
            lc, lg = cpu(1e-3), gpu(1e-3)
            for k in lc:
                torch.testing.assert_close(
                    lg[k].detach().cpu(), lc[k].detach(), **loss_tol,
                    msg=lambda m: f"{name} step {step} {k}: {m}")
        pc, pg = snapshot(cpu.system), snapshot(gpu.system)
        err = max(max_err(pg[n].cpu(), pc[n]) for n in pc)
        require(err <= param_atol, f"{name}: parameters differ by {err}")
        log(f"bf16: small model, {name}, 3 steps, card against CPU: losses "
            f"within {loss_tol}, parameters max_abs_err {err!r} (at most "
            f"{param_atol})")

    # the products of the bf16 step: bf16 GEMMs on the tensor cores
    for name, kw in (("float32", {}),
                     ("compute_dtype=bfloat16",
                      {"compute_dtype": torch.bfloat16}),
                     ("propagate_dtype=bfloat16",
                      {"compute_dtype": torch.bfloat16,
                       "propagate_dtype": torch.bfloat16})):
        step = build_mtl_step(BATCH, FEAT, HIDDEN, device=dev, **kw)
        gemms, busy, idle, n_events, top = profile_step(
            step, LR, f"{tmp}/trace_{name}.json")
        del step
        bf16 = {k: v for k, v in gemms.items() if "BFloat16" in k[0]}
        log(f"bf16: phase-1 step, {name}: device busy {busy!r} ms, idle "
            f"share {idle!r}, {n_events} device events; top kernels "
            f"{json.dumps([[n[:90], ms] for n, ms in top])}")
        for (dtype, dims, kname), (n, us) in sorted(gemms.items()):
            log(f"bf16:   GEMM {dtype} {dims} x{n} {us!r} us {kname[:100]}")
        if name != "float32":
            require(bf16, f"{name}: no matrix product with bf16 operands "
                    f"launched a kernel: {sorted(gemms)}")
        else:
            require(not bf16, f"float32 step ran bf16 GEMMs: {sorted(bf16)}")


def build_kernels() -> None:
    """One nvcc per kernel source, all started together."""
    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = {name: pool.submit(timed, load) for name, load in
                (("fused_adam", tfa.load_library),
                 ("knn_topk", tkt.load_library))}
        times = {name: job.result() for name, job in jobs.items()}
    log(f"build: fused_adam.cu {times['fused_adam']:.1f} s, knn_topk.cu "
        f"{times['knn_topk']:.1f} s with nvcc for sm_90a, in parallel; "
        f"{time.perf_counter() - t0:.1f} s in all")


def run(dev, card: str):
    """Every phase after the checks; returns the kernels' JSON entries and
    a summary of the two paths."""
    build_kernels()

    adam_err = phase_kernels(dev)
    knn_err_max, knn_swaps = phase_knn_kernel(dev)
    mtl, step_ms, launches, steps = phase_train(dev, card)
    phase_small_vs_cpu(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_driver_") as tmp:
        loaded, drv_launches, drv_steps, drv_ms = phase_driver(tmp, card)
        ego_drv = phase_egopack_driver(tmp, card)
        eval_launches = phase_evaluate(tmp, ego_drv)
    ego, ego_ms, knn_launches, ego_steps, main_knn = phase_egopack(
        mtl, loaded, dev, card)
    del loaded
    phase_small_egopack_vs_cpu(dev)
    torch.cuda.empty_cache()
    bench_run = phase_bench(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        phase_bf16(dev, card, tmp)
    nums = phase_numbers(mtl, dev, card)
    knn_nums = phase_knn_numbers(main_knn, dev, card)
    del ego

    # launches on each path, counted from 0 just before it
    kernels = [{
        "name": "fused_adam", "route": "cuda",
        "source": "egopack_torch/ops/csrc/fused_adam.cu",
        "replaces": "egopack_tpu/ops/pallas/fused_adam.py:116",
        "launches": launches, "max_abs_err": adam_err, "ms": nums["ms"],
        "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
        "bound_by": nums["bound_by"], "library_ms": nums["library_ms"],
        "launches_by_path": {"train": launches, "driver": drv_launches,
                             "egopack_driver": ego_drv["adam_launches"],
                             "evaluate": 0, "egopack": ego_steps,
                             "bench": bench_run["adam"]},
    }, {
        "name": "cosine_knn", "route": "cuda",
        "source": "egopack_torch/ops/csrc/knn_topk.cu",
        "replaces": "egopack_tpu/ops/pallas/knn_topk.py:123",
        "launches": knn_launches, "max_abs_err": knn_err_max,
        **knn_nums["main"],
        "launches_by_path": {"egopack_driver": ego_drv["knn_launches"],
                             "evaluate": eval_launches,
                             "egopack": knn_launches,
                             "bench": bench_run["knn"]},
    }]
    summary = (f"fused_adam ({launches} launches in {steps} phase-1 steps; "
               f"{step_ms!r} ms/step; {drv_launches} launches in {drv_steps} "
               f"steps of the phase-1 driver, {drv_ms!r} ms per step; "
               f"{ego_drv['adam_launches']} in {ego_drv['steps']} steps of "
               f"the phase-2 driver, {ego_drv['ms_step']!r} ms per step), "
               f"cosine_knn ({knn_launches} launches "
               f"in {ego_steps} phase-2 steps; {ego_ms!r} ms/step; "
               f"{ego_drv['knn_launches']} in the phase-2 driver's "
               f"{ego_drv['steps']} steps and "
               f"{ego_drv['val_batches'] * DRIVER_EPOCHS} validation batches; "
               f"{eval_launches} in evaluate's {ego_drv['val_batches']} "
               f"batches; {knn_swaps} near-tie swaps in the kernel checks; "
               f"one bench call of {BENCH_SPC} steps per line: fused_adam "
               f"{bench_run['adam']}, cosine_knn {bench_run['knn']})")
    return kernels, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    pkg = Path(egopack_torch.__file__).resolve().parent
    if pkg.parent != HERE:
        print(f"chip_smoke: egopack_torch comes from {pkg}, not from this "
              "checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; ninja {shutil.which('ninja')}")

    kernels, summary = run(dev, card)
    log(f"kernels launched and checked: {summary}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
