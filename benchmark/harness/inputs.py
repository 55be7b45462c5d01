"""Everything a run feeds the program, made from ``--seed``: the weights,
the batches, the prototype banks and the seed of the dropout masks. The
same seed gives the same inputs, and the reference gets the very same.

Batches follow the loader's layouts and label ranges (``data/ego4d.py``
of the program; the published datasets): AR 9 nodes labelled at the
centre, LTA 2 input clips and 20 forecast nodes (verbs from 1), PNR 16
frames with a one-hot keyframe, OSCC 4 nodes with a binary label; features
standard normal. Each task's batches of a pool are one draw on the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Batch = Dict[str, torch.Tensor]

STREAMS = ("weights", "batches", "dropout", "banks")


def stream_seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds for each stream, from any whole ``seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(
        len(STREAMS), dtype=np.uint64)
    return {s: int(v) & (2 ** 63 - 1) for s, v in zip(STREAMS, state)}


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def batch_pool(cfg: dict, groups: int, seed: int,
               device: torch.device) -> List[Dict[str, Batch]]:
    """``groups`` batch groups, one batch a task of the configuration."""
    g = generator(seed, device)
    b, s, d = cfg["batch_size"], cfg["num_segments"], cfg["feature_dim"]
    v, nn_ = cfg["n_verbs"], cfg["n_nouns"]

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device,
                             dtype=torch.int32)

    per_task = {}
    for task in cfg["tasks"]:
        n = cfg["nodes"][task]
        if task == "lta":
            shape = (groups, b, cfg["lta_input_clips"], s, d)
        elif task == "pnr":
            shape = (groups, b, n, d)
        else:
            shape = (groups, b, n, s, d)
        x = torch.randn(shape, generator=g, device=device)
        if task == "oscc":
            y = randint(0, 2, (groups, b))
        elif task == "pnr":
            y = torch.nn.functional.one_hot(
                randint(0, n, (groups, b)).long(), n).to(torch.int32)
        else:
            y = torch.full((groups, b, n, 2), -1, dtype=torch.int32,
                           device=device)
            if task == "ar":
                y[:, :, n // 2, 0] = randint(0, v, (groups, b))
                y[:, :, n // 2, 1] = randint(0, nn_, (groups, b))
            else:
                first = cfg["lta_input_clips"]
                y[:, :, first:, 0] = randint(1, v, (groups, b, n - first))
                y[:, :, first:, 1] = randint(0, nn_, (groups, b, n - first))
        per_task[task] = (x, y)
    valid = torch.ones(b, dtype=torch.bool, device=device)
    return [{t: {"x": x[i], "y": y[i], "valid": valid}
             for t, (x, y) in per_task.items()} for i in range(groups)]


def banks(cfg: dict, seed: int, device: torch.device
          ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Phase 2's frozen prototype banks: ``{aux task: (values (P, F),
    mask (P,))}``, the first ``valid`` of ``rows`` rows valid."""
    g = generator(seed, device)
    aux, rows = cfg["aux_tasks"], cfg["banks"]["rows"]
    values = torch.randn((len(aux), rows, cfg["hidden_size"]), generator=g,
                         device=device)
    mask = torch.arange(rows, device=device) < cfg["banks"]["valid"]
    return {t: (values[i], mask) for i, t in enumerate(aux)}
