"""A dry run of the multi-GPU recipe on N processes of this machine (the
counterpart of ``__graft_entry__.dryrun_multichip``)::

    python -m egopack_torch.parallel.dryrun --nproc 4 [--device cpu]

It starts N ranks itself, on the cards by default (NCCL unless
``EGOPACK_DIST_BACKEND`` says otherwise; rank r on card r mod the number
of cards), or on the CPU with ``--device cpu`` (gloo), on a
``(N/2, 2)`` grid (``(N, 1)`` for odd N), and runs one step of each part
at a tiny size: the phase-1 multi-task train step (data parallelism and
the TRN pooling MLP split over the model axis), a phase-2 EgoPack step
over prototype banks split by row, and a sharded evaluation step. Then it
runs the same on one process and checks that every rank reports the
one-process losses (rtol 1e-4). Exits 0 when they agree.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List, Optional

import torch

FEAT, HIDDEN, P_PAD, FILL = 16, 32, 128, 100
RTOL = 1e-4


def _block(batches, mesh):
    """This rank's block of every global batch."""
    i, d = mesh.data_index, mesh.data
    return {t: {k: v[v.shape[0] // d * i:v.shape[0] // d * (i + 1)]
                for k, v in b.items()} for t, b in batches.items()}


def rank_main(device_name: str) -> Dict[str, float]:
    """One rank's three steps; returns their global losses."""
    import torch.distributed as dist

    from .. import entry
    from ..device import make_generator, resolve_device
    from ..eval.validate import _batch_loss
    from ..models.graphone import GraphONE
    from ..train import optim as topt
    from ..train.system import CKPT_KEYS
    from . import mesh as pmesh
    from . import multihost as mh

    device = resolve_device(device_name)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = mh.initialize(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = 2 if world % 2 == 0 else 1
    mesh = pmesh.make_mesh(world // model, model, device)

    system = entry.build_system(HIDDEN, HIDDEN, FEAT, phase2=True,
                                device=device)
    system.init_params(make_generator(0, device))
    pmesh.replicate(system.params().values())
    pmesh.place_params(system, mesh)
    batch = max(2 * mesh.data, 4)
    batches = _block(entry.synthetic_batches(system, batch, FEAT, seed=0),
                     mesh)

    active = ("ar", "lta", "oscc", "pnr")
    opt = topt.adam(1e-3, 1e-5, impl="fused", trainable_mask=(
        topt.trainable_mask_fn(["temporal_graph"]
                               + [CKPT_KEYS[t] for t in active])))
    state = opt.init(system.params())
    logs = system.make_train_step(opt, active)(
        state, batches, make_generator(1, device), 1e-3)
    out = {f"mtl/{k}": float(v) for k, v in logs.items()}

    graphone = GraphONE(entry.AUX_TASKS, features_size=HIDDEN,
                        hidden_size=HIDDEN, k=4, depth=2, residual=True,
                        device=device)
    graphone.reset_parameters(make_generator(2, device))
    system.attach_graphone(graphone)
    pmesh.place_params(system, mesh)
    banks = pmesh.place_banks(entry.random_banks(P_PAD, FILL, HIDDEN,
                                                 device=device), mesh)
    opt2 = topt.adam(1e-3, 1e-5, impl="fused", trainable_mask=(
        topt.trainable_mask_fn(["temporal_graph", CKPT_KEYS["oscc"],
                                "graphone"])))
    state2 = opt2.init(system.params())
    step2 = system.make_egopack_train_step(opt2, ("oscc",), graphone)
    logs2 = step2(state2, banks, {"oscc": batches["oscc"]},
                  make_generator(3, device), 1e-3)
    out.update({f"egopack/{k}": float(v) for k, v in logs2.items()})

    evaluate = system.make_eval_step("oscc", aux=entry.AUX_TASKS,
                                     graphone=graphone)
    _, per_elem, _, _ = evaluate(batches["oscc"], banks)
    host = {k: v.cpu().numpy() for k, v in batches["oscc"].items()}
    out["eval/oscc_loss"] = _batch_loss(per_elem.cpu().numpy(), host, mesh)
    out["mesh"] = [mesh.data, mesh.model]
    return out


def _launch(nproc: int, device: str, timeout: float) -> List[dict]:
    from .launch import check_ranks, run_ranks
    res = run_ranks([sys.executable, "-m", "egopack_torch.parallel.dryrun",
                     "--rank", "--device", device], nproc, timeout)
    check_ranks(res, f"dry run on {nproc} processes")
    return [json.loads(r.stdout.strip().splitlines()[-1]) for r in res]


def compare(ranks: List[dict], single: dict) -> List[str]:
    """What differs between each rank's losses and the one-process ones."""
    bad = []
    for r, got in enumerate(ranks):
        for k, ref in single.items():
            if k == "mesh":
                continue
            v = got.get(k)
            if v is None or not math.isfinite(v) or not math.isclose(
                    v, ref, rel_tol=RTOL, abs_tol=1e-7):
                bad.append(f"rank {r} {k}: {v!r} against {ref!r}")
    return bad


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--rank", action="store_true",
                    help="run as one rank of a launched world")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.rank:
        print(json.dumps(rank_main(args.device)), flush=True)
        return 0
    ranks = _launch(args.nproc, args.device, args.timeout)
    single = _launch(1, args.device, args.timeout)[0]
    bad = compare(ranks, single)
    for line in bad:
        print(line, file=sys.stderr)
    print(json.dumps({"nproc": args.nproc, "mesh": ranks[0]["mesh"],
                      "losses": {k: v for k, v in ranks[0].items()
                                 if k != "mesh"},
                      "agree": not bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
