"""One rank of the gloo worlds of ``tests/test_torch_port_multiproc.py``.

    python tests/torch_port_multiproc_worker.py <job> <in_dir> <out_dir> \\
        <data> <model> [CLI overrides...]

``job`` ``steps`` runs the grid's pieces on the inputs the test wrote to
``in_dir`` (numpy only: JAX is not imported here) and writes what it got
to ``out_dir/rank<r>.npz``: the phase-1 step, the sharded prototype sweep,
the phase-2 step on banks split by row (frozen and trained) and the
sharded top-k. ``driver`` runs the phase-1 CLI from the initial parameters
in ``in_dir/init.npz``; ``evaluate`` runs the cold evaluation CLI.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from egopack_torch import entry  # noqa: E402
from egopack_torch.device import make_generator  # noqa: E402
from egopack_torch.models.graphone import (GraphONE, PrototypeBank,  # noqa: E402
                                           build_prototypes,
                                           make_prototype_step)
from egopack_torch.ops.knn import prototype_topk  # noqa: E402
from egopack_torch.parallel import mesh as pmesh  # noqa: E402
from egopack_torch.parallel import multihost as mh  # noqa: E402
from egopack_torch.parallel.collectives import shard_of  # noqa: E402
from egopack_torch.train import optim as topt  # noqa: E402
from egopack_torch.train.system import CKPT_KEYS  # noqa: E402

FEAT, HIDDEN = 16, 32
AUX = ("ar", "lta", "pnr")
CPU = torch.device("cpu")


def load(path):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}


def block(batch, mesh):
    """This rank's block of a global batch."""
    b = next(iter(batch.values())).shape[0] // mesh.data
    return {k: v[b * mesh.data_index:b * (mesh.data_index + 1)]
            for k, v in batch.items()}


def batches_of(flat, mesh):
    """``{task: batch}`` from ``task/key`` arrays, this rank's blocks."""
    out = {}
    for key, v in flat.items():
        task, name = key.split("/")
        out.setdefault(task, {})[name] = v
    return {t: block(b, mesh) for t, b in out.items()}


def phase1_system(in_dir, mesh):
    """The phase-1 system at the test's weights, placed on the grid."""
    system = entry.build_system(HIDDEN, HIDDEN, FEAT, tp_dropout=0.0,
                                device=CPU)
    system.load_state(load(f"{in_dir}/phase1.npz"))
    pmesh.place_params(system, mesh)
    return system


def phase1_step(in_dir, mesh, out):
    system = phase1_system(in_dir, mesh)
    active = ("ar", "lta", "oscc", "pnr")
    with open(f"{in_dir}/steps.json") as f:
        impl = json.load(f)["impl"]
    opt = topt.adam(1e-3, 0.01, impl=impl)
    state = opt.init(system.params())
    logs = system.make_train_step(opt, active)(
        state, batches_of(load(f"{in_dir}/batches.npz"), mesh),
        make_generator(7, CPU), 1e-3)
    out.update({f"step/log/{k}": v.numpy() for k, v in logs.items()})
    out.update({f"step/param/{k}": v.detach().numpy()
                for k, v in system.full_params().items()})


def proto_sweep(in_dir, mesh, out):
    system = phase1_system(in_dir, mesh)
    flat = load(f"{in_dir}/proto.npz")
    n = len({k.split("/")[0] for k in flat})
    step = make_prototype_step(system, ("lta", "pnr"), 6, 4)
    banks = build_prototypes(
        step, [block({k: flat[f"{i}/{k}"] for k in ("x", "y", "valid")},
                     mesh) for i in range(n)],
        6, 4, n_tasks=2, data_axis=mesh.data_axis)
    for t, b in banks.items():
        out[f"proto/{t}/values"] = b.values.numpy()
        out[f"proto/{t}/mask"] = b.mask.numpy()


def egopack_step(in_dir, mesh, out, freeze):
    tag = "frozen" if freeze else "trained"
    system = entry.build_system(HIDDEN, HIDDEN, FEAT, tp_dropout=0.0,
                                phase2=True, device=CPU)
    banks = load(f"{in_dir}/banks.npz")
    banks = {t: PrototypeBank(banks[f"{t}/values"], banks[f"{t}/mask"])
             for t in AUX}
    graphone = GraphONE(AUX, features_size=HIDDEN, hidden_size=HIDDEN, k=8,
                        depth=3, residual=False, freeze=freeze, device=CPU)
    system.attach_graphone(graphone, None if freeze else banks)
    system.load_state(load(f"{in_dir}/phase2_{tag}.npz"))
    pmesh.place_params(system, mesh)
    banks = pmesh.place_banks(banks, mesh)
    trainable = ["temporal_graph", CKPT_KEYS["oscc"], "graphone"]
    if not freeze:
        trainable.append("graphone_banks")
    opt = topt.adam(1e-3, 0.0, trainable_mask=topt.trainable_mask_fn(
        trainable))
    state = opt.init(system.params())
    step = system.make_egopack_train_step(opt, ("oscc",), graphone)
    batch = batches_of(load(f"{in_dir}/batches.npz"), mesh)["oscc"]
    logs = step(state, banks, {"oscc": batch}, make_generator(3, CPU), 1e-3)
    out[f"{tag}/loss"] = logs["oscc_loss"].numpy()
    out.update({f"{tag}/param/{k}": v.detach().numpy()
                for k, v in system.full_params().items()})


def topk(in_dir, mesh, out):
    z = load(f"{in_dir}/knn.npz")
    # (T, P, F) banks: this rank's rows of each
    idx, dist = prototype_topk(z["features"],
                               shard_of(z["bank"], mesh.model_axis, 1),
                               shard_of(z["mask"], mesh.model_axis, 1),
                               int(z["k"]), axis=mesh.model_axis)
    out["knn/idx"], out["knn/dist"] = idx.numpy(), dist.numpy()


def steps(in_dir, out_dir, mesh):
    out = {}
    with open(f"{in_dir}/steps.json") as f:
        jobs = json.load(f)["jobs"]
    phase1_step(in_dir, mesh, out)
    if "proto" in jobs:
        proto_sweep(in_dir, mesh, out)
    if "egopack" in jobs:
        egopack_step(in_dir, mesh, out, freeze=True)
        egopack_step(in_dir, mesh, out, freeze=False)
    if "topk" in jobs:
        topk(in_dir, mesh, out)
    np.savez(f"{out_dir}/rank{mesh.rank}.npz", **out)


def driver(in_dir, argv):
    """The phase-1 CLI, started from ``in_dir/init.npz``."""
    from egopack_torch import main_temporal
    from egopack_torch.train import system as tsystem
    init = load(f"{in_dir}/init.npz")

    def init_params(self, generator):
        self.load_state({k: v.to(self.device) for k, v in init.items()})
        return self.params()

    tsystem.MultiTaskSystem.init_params = init_params
    main_temporal.main(argv)


def main():
    job, in_dir, out_dir = sys.argv[1:4]
    data, model = int(sys.argv[4]), int(sys.argv[5])
    torch.set_num_threads(1)
    if job == "steps":
        mh.initialize(CPU)
        steps(in_dir, out_dir, pmesh.make_mesh(data, model, CPU))
    elif job == "driver":
        driver(in_dir, sys.argv[6:])
    elif job == "evaluate":
        from egopack_torch.evaluate import main as evaluate_main
        evaluate_main(sys.argv[6:])
    else:
        raise ValueError(job)


if __name__ == "__main__":
    main()
