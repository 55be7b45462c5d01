#!/usr/bin/env python3
"""Drive the PyTorch port (``egopack_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero and prints no result:

1. build   - compile every kernel of the path from ``egopack_torch/ops/csrc``
             with nvcc for sm_90a (into ``egopack_torch/_build/``).
2. kernels - fused Adam against its plain PyTorch version over the full-width
             leaf set (61 trainable leaves + the frozen OSCC head), 3 steps
             with float32 and 3 with bfloat16 moments. Tolerance: one unit in
             the last place of the stored dtype (the kernel is built with
             --fmad=false and is expected to agree bit for bit); frozen
             leaves bit-identical.
3. train   - the phase-1 AR+LTA+PNR train step at full width (hidden 1024,
             feat 1536, batch 16 per task, fused Adam, dropout 0.5 from a
             seeded generator): 3 warm-up + 20 timed steps. Launch counts are
             zeroed just before and read just after. Finite losses, moved
             trainable parameters, an unchanged OSCC head. Then one step with
             dropout off against the same step with the plain Adam, and a
             small model on the card against the same model on the CPU.
4. numbers - ms per step; the kernel's device time per step (f32 and bf16
             moments), its launches and its bound; the plain version's time;
             ``torch.optim.Adam(fused=True)`` on the same tensors as the
             library yardstick (timed only; the port never calls it).

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import egopack_torch
from egopack_torch.device import make_generator
from egopack_torch.entry import ACTIVE, build_mtl_step, build_system
from egopack_torch.ops import fused_adam as tfa
from egopack_torch.profiling import busy_us, device_events
from egopack_torch.train import optim as topt
from egopack_torch.train.system import CKPT_KEYS

HERE = Path(__file__).resolve().parent
FEAT, HIDDEN, BATCH = 1536, 1024, 16
LR, WD = 1e-5, 1e-5
WARMUP, TIMED = 3, 20
TRAINABLE = ["temporal_graph"] + [CKPT_KEYS[t] for t in ACTIVE]
F32_ULP, BF16_ULP = 2.0 ** -23, 2.0 ** -7
# float32 operations of one Adam element: decay 2, moments 6, update 5
ADAM_FLOPS_PER_ELEM = 13
FP32_PEAK = 67e12  # FLOP/s outside the tensor cores, H100 SXM data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def hbm_bytes_per_s(name: str) -> float:
    """Peak device-memory rate by SKU (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name:
        if "PCIe" in name:
            return 2.0e12
        if "NVL" in name:
            return 3.9e12
        return 3.35e12  # SXM (HBM3)
    raise RuntimeError(f"no memory rate on record for {name!r}")


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


def device_ms(fn, iters: int) -> float:
    """Device time of ``fn`` per call: the time the card is busy with the
    kernels, copies and fills of ``iters`` calls (``torch.profiler``), over
    ``iters``. Gaps in which the card waits for the host are not counted."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    require(bool(events), "the profiler recorded no device events")
    return busy_us(events) / 1e3 / iters


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


def phase_numbers(mtl, dev, card: str) -> dict:
    """The kernel (f32 and bf16 moments), the plain version and the library
    call on the same full-width trainable tensors, each timed twice in turns
    (one order, then the reverse) and two ways: ``device_ms``, the arm's own
    time on the card, and ``time_ms``, which also counts the gaps in which
    the card waits for the host to launch the next kernel."""
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
    order = ("plain", "fused", "library", "fused_bf16")
    for seq in (order, order[::-1]):
        for k in seq:
            dev_runs[k].append(device_ms(arms[k], 30))
            gap_runs[k].append(time_ms(arms[k], 30))
    ms = {k: sum(v) / len(v) for k, v in dev_runs.items()}
    gap_ms = {k: sum(v) / len(v) for k, v in gap_runs.items()}
    launches0 = tfa.fused_adam.launches
    arms["fused"]()
    per_call = tfa.fused_adam.launches - launches0
    rate = hbm_bytes_per_s(card)
    bound_bytes_ms = 28 * numel / rate * 1e3
    bound_ops_ms = ADAM_FLOPS_PER_ELEM * numel / FP32_PEAK * 1e3
    log(f"numbers: {numel} trainable elements in {len(names)} leaves, "
        f"fused_adam {per_call} launch(es) per step; device ms per step "
        f"(torch.profiler): fused_adam {ms['fused']!r}, bf16 moments "
        f"{ms['fused_bf16']!r}, plain {ms['plain']!r}, "
        f"torch.optim.Adam(fused=True) {ms['library']!r}; bound "
        f"{bound_bytes_ms!r} (28 B/elem), bf16 {20 * numel / rate * 1e3!r} "
        f"(20 B/elem) at {rate:.3g} B/s; on {card}")
    log(f"numbers: with launch gaps (CUDA events) ms per step: fused_adam "
        f"{gap_ms['fused']!r}, bf16 moments {gap_ms['fused_bf16']!r}, plain "
        f"{gap_ms['plain']!r}, library {gap_ms['library']!r}; on {card}")
    log(f"numbers: runs device {json.dumps(dev_runs)}; with gaps "
        f"{json.dumps(gap_runs)}")
    return {"ms": ms["fused"], "plain_ms": ms["plain"],
            "library_ms": ms["library"],
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
            else "operations"}


def run(dev, card: str):
    """Every phase after the checks; returns (kernels, steps, ms/step)."""
    t0 = time.perf_counter()
    tfa.load_library()
    log(f"build: fused_adam.cu with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")

    err = phase_kernels(dev)
    mtl, step_ms, launches, steps = phase_train(dev, card)
    phase_small_vs_cpu(dev)
    nums = phase_numbers(mtl, dev, card)

    kernels = [{
        "name": "fused_adam", "route": "cuda",
        "source": "egopack_torch/ops/csrc/fused_adam.cu",
        "replaces": "egopack_tpu/ops/pallas/fused_adam.py:116",
        "launches": launches, "max_abs_err": err, "ms": nums["ms"],
        "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
        "bound_by": nums["bound_by"], "library_ms": nums["library_ms"],
    }]
    return kernels, steps, step_ms


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

    kernels, steps, step_ms = run(dev, card)
    log(f"kernels launched and checked: fused_adam "
        f"({kernels[0]['launches']} launches in {steps} train steps; "
        f"{step_ms!r} ms/step)")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
