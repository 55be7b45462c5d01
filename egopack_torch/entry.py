"""Entry points of the phase-1 multi-task train step (counterpart of
``__graft_entry__._build_system`` / ``_synthetic_batches`` and of what
``bench.py:build_mtl_step`` drives).

``build_mtl_step`` assembles the whole path: system, seeded init, the
driver's trainable mask (backbone + active heads; the OSCC head stays
frozen), Adam and the train step, plus synthetic batches made from a numpy
seed exactly as the JAX entry makes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .data import graphs as G
from .device import DeviceLike, make_generator, resolve_device
from .models.backbone import TemporalGraph
from .models.heads import LTATask, OSCCTask, PNRTask, RecognitionTask
from .models.pooling import TRNPooling
from .train import optim as topt
from .train.system import CKPT_KEYS, MultiTaskSystem, TaskSetup

N_VERBS, N_NOUNS = 115, 478  # Ego4D v1 FHO taxonomy sizes
ACTIVE = ("ar", "lta", "pnr")


def build_system(hidden: int, tp_hidden: int, feat_dim: int,
                 num_segments: int = 3, tp_dropout: float = 0.5, *,
                 compute_dtype: torch.dtype = torch.float32,
                 fused_layout: str = "auto",
                 device: DeviceLike = None) -> MultiTaskSystem:
    """Backbone (TRN pooling + 3 SAGE layers) and the four phase-1 heads.
    Parameters are zeros until ``init_params`` or ``load_state``."""
    dev = resolve_device(device)
    pooling = TRNPooling(feat_dim, hidden, num_segments, hidden_size=tp_hidden,
                         dropout=tp_dropout, device=dev)
    backbone = TemporalGraph(feat_dim, hidden, depth=3,
                             temporal_pooling=pooling,
                             num_segments=num_segments, device=dev)
    heads = {
        "ar": RecognitionTask("ar", hidden, hidden, heads=(N_VERBS, N_NOUNS),
                              device=dev),
        "oscc": OSCCTask("oscc", hidden, hidden, device=dev),
        "lta": LTATask("lta", hidden, hidden, heads=(N_VERBS, N_NOUNS),
                       device=dev),
        "pnr": PNRTask("pnr", hidden, hidden, device=dev),
    }
    specs = {"ar": G.ar_spec(9, 1.0), "oscc": G.oscc_spec(1.0),
             "lta": G.lta_spec(2, 20, 1.0), "pnr": G.pnr_spec(16, 1.0)}
    tasks = {n: TaskSetup(n, heads[n], specs[n], 1.0,
                          append_node="avg" if n == "lta" else None)
             for n in heads}
    return MultiTaskSystem(backbone, tasks, compute_dtype, fused_layout,
                           device=dev)


def synthetic_batches(system: MultiTaskSystem, batch: int, feat_dim: int,
                      num_segments: int = 3, seed: int = 0
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Production-layout batches on the system's device, drawn with numpy
    exactly as the JAX entry draws them: LTA ships its 2 input clips, PNR
    un-repeated frames."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, setup in system.tasks.items():
        n = setup.spec.num_nodes
        if name == "lta":
            x = rng.normal(size=(batch, 2, num_segments, feat_dim))
        elif name == "pnr":
            x = rng.normal(size=(batch, n, feat_dim))
        else:
            x = rng.normal(size=(batch, n, num_segments, feat_dim))
        x = x.astype(np.float32)
        if name == "oscc":
            y = rng.integers(0, 2, size=(batch,)).astype(np.int32)
        elif name == "pnr":
            y = np.zeros((batch, n), np.int32)
            y[np.arange(batch), rng.integers(0, n, batch)] = 1
        else:
            y = np.full((batch, n, 2), -1, np.int32)
            if name == "ar":
                y[:, n // 2, 0] = rng.integers(0, N_VERBS, batch)
                y[:, n // 2, 1] = rng.integers(0, N_NOUNS, batch)
            else:
                y[:, 2:, 0] = rng.integers(1, N_VERBS, (batch, n - 2))
                y[:, 2:, 1] = rng.integers(0, N_NOUNS, (batch, n - 2))
        out[name] = {"x": x, "y": y, "valid": np.ones(batch, bool)}
    return to_device(out, system.device)


def to_device(batches: Dict[str, Dict[str, np.ndarray]],
              device: DeviceLike = None) -> Dict[str, Dict[str, torch.Tensor]]:
    dev = resolve_device(device)
    return {name: {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            for name, b in batches.items()}


@dataclass
class MTLStep:
    system: MultiTaskSystem
    optimizer: topt.Adam
    opt_state: topt.AdamState
    step: Callable
    batches: Dict[str, Dict[str, torch.Tensor]]
    generator: torch.Generator

    def __call__(self, lr: float = 1e-5) -> Dict[str, torch.Tensor]:
        return self.step(self.opt_state, self.batches, self.generator, lr)


def build_mtl_step(batch: int = 16, feat_dim: int = 1536, hidden: int = 1024,
                   *, impl: str = "fused", moments_dtype: str = "float32",
                   compute_dtype: torch.dtype = torch.float32,
                   fused_layout: str = "auto", tp_dropout: float = 0.5,
                   active: Tuple[str, ...] = ACTIVE, log_norms: bool = True,
                   seed: int = 0, device: DeviceLike = None) -> MTLStep:
    """The phase-1 AR+LTA+PNR train step at the bench configuration
    (hidden 1024, feat 1536, batch 16 per task by default), Adam(1e-5,
    wd 1e-5) over the driver's trainable mask."""
    dev = resolve_device(device)
    system = build_system(hidden, hidden, feat_dim, tp_dropout=tp_dropout,
                          compute_dtype=compute_dtype,
                          fused_layout=fused_layout, device=dev)
    generator = make_generator(seed, dev)
    system.init_params(generator)
    mask = topt.trainable_mask_fn(["temporal_graph"]
                                  + [CKPT_KEYS[t] for t in active])
    optimizer = topt.adam(1e-5, 1e-5, trainable_mask=mask,
                          moments_dtype=moments_dtype, impl=impl)
    opt_state = optimizer.init(system.params())
    step = system.make_train_step(optimizer, active, log_norms=log_norms)
    batches = {n: b for n, b in synthetic_batches(system, batch, feat_dim,
                                                  seed=seed).items()
               if n in active}
    return MTLStep(system, optimizer, opt_state, step, batches, generator)
