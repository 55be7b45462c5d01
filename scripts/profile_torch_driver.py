#!/usr/bin/env python3
"""Where the time of the port's phase-1 driver goes, on one NVIDIA card.

    python3 scripts/profile_torch_driver.py [--epochs 3] [--repeats 2]

Writes a seeded Ego4D-layout fixture (1536-d features, 115 verbs, 478 nouns,
8 videos: 15 AR steps an epoch at batch 16) to a temporary directory and runs
``egopack_torch.main_temporal`` on it at full width (hidden 1024, TRN hidden
1024, dropout 0.5, AR+LTA+PNR, fused Adam): the driver's own per-epoch ms
per optimizer step and the host's wait for data.

Then, with the trained system, one epoch's worth of steps (15, one a batch
group, as the driver runs them) in five arms, in turns (the given order,
then reversed), each timed by the host clock up to a synchronize:

- ``steps``: the batch groups already on the card, steps only;
- ``loop``: the driver's loop, loading included (prefetch threads, pinned
  copies on a side stream);
- ``loop_switch``: ``loop`` with the interpreter's switch interval at
  0.5 ms (5 ms by default), which shortens the main thread's waits for the
  interpreter lock behind the prefetch threads;
- ``data``: the loading alone, no steps;
- ``data_serial``: ``data`` with the batches built in the main thread (no
  prefetch threads).

And ``steps`` and ``loop`` once each under ``torch.profiler``: the device's
busy time (union of kernel intervals) and idle share, kernels per step, and
the host operations with the most self time. Last, the loading's parts in
the main thread alone: ``get()`` per sample of each task, ``collate`` per
batch, and the copy of a batch to the card (pinned and non-blocking on a
side stream, as the driver does, and a plain blocking copy), with the
host's core counts.

Prints the card's name and power limit, then one JSON line. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from egopack_torch.data.loader import (DeviceCopier,  # noqa: E402
                                       MultiLoader, device_prefetch)
from egopack_torch.data.synthetic import generate_ego4d_fixture  # noqa: E402
from egopack_torch.main_temporal import main as train_main  # noqa: E402
from egopack_torch.profiling import busy_us, device_events  # noqa: E402
from egopack_torch.train.driver import TASKS  # noqa: E402


def overrides(root: str, tmp: str, epochs: int):
    return ["k=1", "batch_size=16", "model.hidden_size=1024",
            "model.temporal_pooling.hidden_size=1024",
            "model.temporal_pooling.dropout=0.5", "enabled_tasks=[ar,lta,pnr]",
            "optimizer.impl=fused", f"num_epochs={epochs}",
            "validation_split=val",
            f"dataset_recognition.root={root}", f"dataset_oscc.root={root}",
            f"dataset_lta.root={root}", f"dataset_pnr.root={root}",
            f"artifact_dir={tmp}/artifacts", f"output_dir={tmp}/outputs"]


class Arms:
    """The timed arms over the driver's trained system."""

    def __init__(self, result):
        system, opt = result["system"], result["optimizer"]
        self.system, self.state = system, result["opt_state"]
        self.dsets = result["dsets"]
        self.active = ("ar", "lta", "pnr")
        self.step = system.make_train_step(opt, self.active)
        self.copier = DeviceCopier(system.device)
        self.gen = torch.Generator(device=system.device).manual_seed(0)
        self.epoch = 10  # a pass the driver did not run
        self.groups = [self.copier.ready(g) for g in
                       (self.put(t) for t in self.multiloader())]

    def multiloader(self):
        self.epoch += 1
        for t in TASKS:
            self.dsets[t]["dl_train"].set_epoch(self.epoch)
        weights = [1 if t in self.active else 0 for t in TASKS]
        return MultiLoader([self.dsets[t]["dl_train"] for t in TASKS],
                           weights)

    def put(self, tup):
        return {t: self.copier.put(b) for t, b in zip(TASKS, tup)
                if t in self.active}

    def run_steps(self, groups) -> int:
        n = 0
        for g in groups:
            self.step(self.state, g, self.gen, 1e-6)
            n += 1
        return n

    def steps(self) -> int:
        return self.run_steps(self.groups)

    def loop(self) -> int:
        return self.run_steps(device_prefetch(iter(self.multiloader()),
                                              self.put, self.copier.ready))

    def loop_switch(self) -> int:
        old = sys.getswitchinterval()
        sys.setswitchinterval(0.0005)
        try:
            return self.loop()
        finally:
            sys.setswitchinterval(old)

    def data(self) -> int:
        n = 0
        for _ in device_prefetch(iter(self.multiloader()), self.put,
                                 self.copier.ready):
            n += 1
        return n

    def data_serial(self) -> int:
        loaders = [self.dsets[t]["dl_train"] for t in TASKS]
        depths = [dl.prefetch for dl in loaders]
        for dl in loaders:
            dl.prefetch = 0
        try:
            return self.data()
        finally:
            for dl, d in zip(loaders, depths):
                dl.prefetch = d


def host_parts(arms: Arms, reps: int = 64) -> dict:
    """The loading's parts, each in the main thread with nothing else
    running: µs per sample of ``get()``, ms per batch of ``collate`` and of
    the copies to the card."""
    import numpy as np
    from egopack_torch.data.loader import collate
    out = {"cpu_count": os.cpu_count(),
           "affinity": len(os.sched_getaffinity(0))}
    for t in arms.active:
        ds = arms.dsets[t]["train"]
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        samples = [ds.get(i % len(ds), rng) for i in range(reps)]
        out[f"get_us_{t}"] = (time.perf_counter() - t0) / reps * 1e6
        t0 = time.perf_counter()
        batches = [collate(samples[:16], pad_to=16) for _ in range(8)]
        out[f"collate_ms_{t}"] = (time.perf_counter() - t0) / 8 * 1e3
        for name, put in (("pinned", lambda b: arms.copier.ready(
                              arms.copier.put(b))),
                          ("blocking", lambda b: {
                              k: torch.as_tensor(v, device=arms.system.device)
                              for k, v in b.items()
                              if k in ("x", "y", "valid")})):
            put(batches[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                put(b)
            torch.cuda.synchronize()
            out[f"copy_ms_{name}_{t}"] = (time.perf_counter() - t0) / 8 * 1e3
    return out


def timed(fn) -> float:
    """ms per step of ``fn()`` (which returns its step count), host clock up
    to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def profiled(fn, top: int):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_events(prof)
    busy = busy_us(events)
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
            "busy_ms_per_step": busy / n / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "kernels_per_step": len(events) / n,
            "host_self_ms_per_step": {
                a.key: a.self_cpu_time_total / n / 1e3 for a in ops[:top]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_driver: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="profile_driver_") as tmp:
        root = generate_ego4d_fixture(f"{tmp}/ego4d", feature_dim=1536,
                                      n_videos=8, n_verbs=115, n_nouns=478,
                                      n_oscc=64, learnable=True)
        result = train_main(overrides(root, tmp, args.epochs))
        epochs = [{"epoch": s["epoch"], "steps": s["steps"],
                   "ms_per_step": s["train_s"] / s["steps"] * 1e3,
                   "data_ms_per_step": s["data_s"] / s["steps"] * 1e3}
                  for s in result["epochs"]]
        for e in epochs:
            print(f"driver epoch {e['epoch']}: {e['ms_per_step']!r} ms per "
                  f"optimizer step, {e['data_ms_per_step']!r} ms of it "
                  f"waiting for data ({e['steps']} steps)", flush=True)
        arms = Arms(result)
        names = ("steps", "loop", "loop_switch", "data", "data_serial")
        runs = {n: [] for n in names}
        for _ in range(args.repeats):
            for seq in (names, names[::-1]):
                for n in seq:
                    runs[n].append(timed(getattr(arms, n)))
        for n in names:
            print(f"arm {n}: ms per step {runs[n]}", flush=True)
        prof = {n: profiled(getattr(arms, n), args.top)
                for n in ("steps", "loop")}
        for n, p in prof.items():
            print(f"profiled {n}: {json.dumps(p)}", flush=True)
        parts = host_parts(arms)
        print(f"host parts: {json.dumps(parts)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "driver_epochs": epochs, "arms": runs,
                      "profiled": prof, "host_parts": parts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
