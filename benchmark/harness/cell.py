"""One run of one cell: set-up, the measured window, the correctness
check, and the result line's contents."""

from __future__ import annotations

import gc
import statistics
import subprocess
import time
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

from . import check, counts, inputs, trace, window
from .manifest import Manifest
from .program import ProgramStep, knn_recorder
from ..reference import model as ref_model
from ..reference import params as ref_params

WARMUP = 3  # steps after the checked ones, before the window


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"{torch.cuda.get_device_name(device)}, power limit not read " \
               f"({e})"


def _set_precision() -> None:
    """float32 products in float32: TF32 off, as the configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float,
             traced: bool, device: torch.device, started: float,
             overrides: Optional[dict] = None,
             fault: Optional[Callable] = None,
             log: Callable[[str], None] = print) -> dict:
    """One run; returns the result line's object. ``overrides`` change
    configuration entries and ``fault`` breaks the step (both for the
    tests only)."""
    _set_precision()
    cfg, traffic, kind_of_feed = manifest.setting(name)
    cfg = {**cfg, **(overrides or {})}
    limits = manifest.limits(name)
    seeds = inputs.stream_seeds(seed)
    card = card_line(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"card: {card}")

    feed, step, rec = program_first_steps(cfg, traffic, kind_of_feed, seeds,
                                          device, fault)
    for _ in range(WARMUP):
        step(feed.next()[0])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - started

    knn_launches = None
    if cfg["phase"] == 2:
        from egopack_torch.ops import knn_topk
        knn_launches = lambda: knn_topk.cosine_knn.launches  # noqa: E731
    wanted = {m["name"] for m in manifest.end_to_end(name)}
    res = window.run(step, feed, seconds, traced, device, knn_launches,
                     busy="device_ms_per_step" in wanted)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    totals = torch.stack([step.total_loss(l).detach() for l in res.logs])
    failed = int((~torch.isfinite(totals)).sum())
    attempted = len(res.logs)
    trainable = ref_params.trainable_elements(cfg)
    ctx = trace.Context(cfg, kind, res, counts.step_flops(cfg), trainable)
    log(f"window: {res.steps} steps, {res.clips} clips in "
        f"{res.seconds!r} s ({res.clips / res.seconds!r} clips/s); step "
        f"times from {len(res.step_ms)} steps, p95 {res.p95_ms()!r} ms; "
        f"memory peak {peak} B")
    if len(res.step_ms) > 1:
        q = statistics.quantiles(res.step_ms, n=4)
        log(f"step ms quartiles {q[0]!r} {q[1]!r} {q[2]!r}; host ms a "
            f"step {res.host_s / max(res.host_steps, 1) * 1e3!r}")
    if res.step_ms:
        chunks, t, n = [], 0.0, 0
        for ms in res.step_ms:
            t += ms
            n += 1
            if t >= 2000.0:
                chunks.append(round(n / t * 1e3, 1))
                t, n = 0.0, 0
        log(f"steps a second, by 2 s of the window: {chunks}")
    for line in res.dropped:
        log(f"profiler dropped events: {line}")

    # the program's state goes before the reference runs
    del step, totals, res.logs[:]
    feed.close()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    run = reference_run(cfg, traffic, kind_of_feed, seeds, device, rec.knn,
                        follow=rec.grads)
    t_num = time.perf_counter()
    values = check.numbers(cfg, rec, run)
    del run
    log(f"reference: {t_num - t_ref!r} s, then its comparison: "
        f"{time.perf_counter() - t_num!r} s")
    ok, checks = check.verdict(values, limits)

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(ok and failed == 0), "attempted": attempted,
           "failed": failed}
    if traced:
        out["metrics"] = manifest.read_metrics(name, ctx)
        busy, span = trace.device_totals(ctx.device_stretches())
        device_info.update(busy_s=busy, window_s=span)
        out["device"] = device_info
        out["breakdown"] = trace.breakdown(res.stretches)
    else:
        e2e = {"clips_per_s": (res.clips / res.seconds, "clips/s"),
               "device_ms_per_step": (
                   trace.device_ms_per_step(ctx.device_stretches()), "ms"),
               "setup_s": (setup_s, "s")}
        out["metrics"] = {k: {"value": v, "unit": u}
                          for k, (v, u) in e2e.items()
                          if k in wanted and v is not None}
        out["device"] = device_info
    out["checks"] = checks
    return out


def program_first_steps(cfg: dict, traffic: dict, kind: ModuleType,
                        seeds: Dict[str, int], device: torch.device,
                        fault: Optional[Callable] = None):
    """Build the feed (of the feed kind ``kind``) and the program's step
    from the seeds and take the checked first steps:
    ``(feed, step, record)``."""
    weights = ref_params.init_params(
        cfg, inputs.generator(seeds["weights"], device), device)
    bank_data = (inputs.banks(cfg, seeds["banks"], device)
                 if cfg["phase"] == 2 else None)
    feed = kind.make(cfg, traffic, seeds["batches"], device)
    step = ProgramStep(cfg, weights, bank_data,
                       inputs.generator(seeds["dropout"], device), device)
    del weights, bank_data
    if fault is not None:
        step = fault(step)
    rec = check.record_first_steps(
        step, feed, knn_recorder if cfg["phase"] == 2 else None,
        all_grads=ref_model.pools_over_nodes(cfg))
    return feed, step, rec


def reference_run(cfg: dict, traffic: dict, kind: ModuleType,
                  seeds: Dict[str, int], device: torch.device, knn_seen=None,
                  knn_dtype: torch.dtype = torch.float64, follow=(),
                  keep_grads: bool = False):
    """The reference's first steps on the run's inputs, made again from
    the seeds, following the program's k-NN lists (``knn_seen``) and
    gradients (``follow``) where it judges them."""
    weights = ref_params.init_params(
        cfg, inputs.generator(seeds["weights"], device), device)
    groups = kind.reference_groups(cfg, traffic, seeds["batches"], device,
                                   check.STEPS)
    banks = (inputs.banks(cfg, seeds["banks"], device)
             if cfg["phase"] == 2 else None)
    return check.reference_steps(
        cfg, weights, groups, inputs.generator(seeds["dropout"], device),
        banks, knn_seen, knn_dtype, follow, keep_grads)


def reference_numbers(cfg: dict, traffic: dict, kind: ModuleType,
                      seeds: Dict[str, int], device: torch.device,
                      rec: check.Record) -> Dict[str, float]:
    """The numbers compared: the program's record against the
    reference."""
    return check.numbers(cfg, rec, reference_run(cfg, traffic, kind, seeds,
                                                 device, rec.knn,
                                                 follow=rec.grads))


def control_numbers(cfg: dict, traffic: dict, kind: ModuleType,
                    seeds: Dict[str, int], device: torch.device
                    ) -> Dict[str, float]:
    """The control: the reference in the program's place, its products in
    TF32 (the precision below the configurations' float32), against the
    reference."""
    from .faults import tf32
    tf32(True)
    try:
        low = reference_run(cfg, traffic, kind, seeds, device,
                            knn_dtype=torch.float32, keep_grads=True)
    finally:
        tf32(False)
    rec = check.Record(low.names, low.losses, low.first_grad, low.change(),
                       grad={n: t.cpu() for n, t in
                             low.first_grad_tensors.items()},
                       knn=low.knn.produced if low.knn else [],
                       groups=[{t: {k: v.cpu() for k, v in b.items()}
                                for t, b in g.items()} for g in low.groups],
                       grads=low.step_grads)
    return check.numbers(cfg, rec, reference_run(cfg, traffic, kind, seeds,
                                                 device, rec.knn,
                                                 follow=rec.grads))


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]
