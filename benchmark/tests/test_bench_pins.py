"""The two configurations that have cells read what they read before phase
2 followed the configuration's novel task: the weights' leaf list and
draw, the batches, the banks, the step's operation and k-NN counts, and
the first steps of the program and of the reference. The pinned values
were read on the parent of that change."""

import hashlib

import pytest
import torch

from benchmark.harness import cell as cells, counts, inputs
from benchmark.harness.manifest import Manifest
from benchmark.reference import params
from benchmark.tests.tiny import OVERRIDES, ROOT

CARD = "NVIDIA H100 80GB HBM3"
SEED = 2147483811
CELLS = {"mtl-step": "egopack-mtl-ar-lta-pnr",
         "novel-oscc-step": "egopack-novel-oscc"}


def _digest(items) -> str:
    h = hashlib.sha256()
    for name, t in items:
        h.update(name.encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _cfg(cell, tiny=True):
    cfg = Manifest(ROOT).config(CELLS[cell])
    return {**cfg, **OVERRIDES[cell]} if tiny else cfg


def readings(cell) -> dict:
    """What the pins hold, read from this checkout."""
    full, cfg = _cfg(cell, tiny=False), _cfg(cell)
    dev = torch.device("cpu")
    seeds = inputs.stream_seeds(SEED)
    spec = hashlib.sha256(repr(params.param_spec(full)).encode())
    weights = params.init_params(cfg, inputs.generator(seeds["weights"], dev),
                                 dev)
    pool = inputs.batch_pool(cfg, 4, seeds["batches"], dev)
    out = {"spec": spec.hexdigest()[:16],
           "weights": _digest(weights.items()),
           "pool": _digest((f"{i}.{t}.{k}", v) for i, g in enumerate(pool)
                           for t, b in g.items() for k, v in b.items()),
           "step_flops": counts.step_flops(full)}
    if full["phase"] == 2:
        out["banks"] = _digest((f"{t}.{i}", v) for t, pair in
                               inputs.banks(cfg, seeds["banks"], dev).items()
                               for i, v in enumerate(pair))
        out["knn_least_s"] = counts.knn_least_s(full, CARD)
    m = Manifest(ROOT)
    _, traffic, kind = m.setting(cell)
    feed, step, rec = cells.program_first_steps(cfg, traffic, kind, seeds,
                                                dev)
    feed.close()
    run = cells.reference_run(cfg, traffic, kind, seeds, dev, rec.knn)
    out["program_losses"] = rec.losses
    out["reference_losses"] = run.losses
    out["reference_grad"] = sum(run.first_grad.values())
    out["reference_change"] = sum(run.change().values())
    return out


PINS = {
    "mtl-step": {
        "spec": "e8df9fabccb659ec",
        "weights": "2c8a4298432f8b27",
        "pool": "86e9aaed887110ff",
        "step_flops": 89187581952,
        "program_losses": [12.088953018188477, 12.040326118469238,
                           11.971349716186523],
        "reference_losses": [12.088953018188477, 12.040326118469238,
                             11.971349716186523],
        "reference_grad": 12.019285308364603,
        "reference_change": 0.02986992300902013,
    },
    "novel-oscc-step": {
        "spec": "fc34807340354c70",
        "weights": "5b41ac5669fb2d5e",
        "pool": "5e6581d68f82bc3f",
        "step_flops": 18525978624,
        "banks": "5202fc8cb6170610",
        "knn_least_s": (7.6112238805970145e-06, "bytes"),
        "program_losses": [0.713563084602356, 0.804219663143158,
                           0.7051712274551392],
        "reference_losses": [0.713563084602356, 0.804219663143158,
                             0.7051712870597839],
        "reference_grad": 6.346173899515762,
        "reference_change": 0.001985952149841959,
    },
}

EXACT = ("spec", "weights", "pool", "banks", "step_flops", "knn_least_s")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_cell_reads_what_its_parent_read(cell):
    got, want = readings(cell), PINS[cell]
    assert set(got) == set(want)
    for key in EXACT:
        if key in want:
            assert got[key] == want[key], key
    for key in set(want) - set(EXACT):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key


if __name__ == "__main__":  # print the readings of this checkout
    import json
    print(json.dumps({c: readings(c) for c in sorted(CELLS)}, indent=1))
