"""Entry points of the phase-1 multi-task train step and the phase-2
EgoPack step (counterpart of ``__graft_entry__._build_system`` /
``_synthetic_batches`` / ``make_device_batch_gen`` and of what
``bench.py:build_mtl_step`` and ``build_egopack_step`` drive).

``build_mtl_step`` assembles the phase-1 path: system, seeded init, the
driver's trainable mask (backbone + active heads; the OSCC head stays
frozen), Adam and the train step, plus synthetic batches made from a numpy
seed exactly as the JAX entry makes them, or on the card
(``device_batches``). ``build_egopack_step`` assembles the novel-OSCC
phase-2 path as ``train/driver.py:train_egopack`` does: phase-2 system, the
phase-1 state merged in, prototype banks, GraphONE, Adam over the phase-2
trainable mask and the EgoPack step. With ``steps_per_call`` K > 1 a
call of either step object runs the one train step over K batch groups in
turn, as the bench does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch

from .data import graphs as G
from .device import DeviceLike, make_generator, resolve_device
from .models.backbone import TemporalGraph
from .models.graphone import (GraphONE, PrototypeBank, build_prototypes,
                              make_prototype_step)
from .models.heads import LTATask, OSCCTask, PNRTask, RecognitionTask
from .models.pooling import TRNPooling
from .train import optim as topt
from .train.checkpoint import merge_loaded_params
from .train.system import CKPT_KEYS, MultiTaskSystem, TaskSetup, norms_due

N_VERBS, N_NOUNS = 115, 478  # Ego4D v1 FHO taxonomy sizes
ACTIVE = ("ar", "lta", "pnr")
# phase-2 aux classifier sets (__graft_entry__.py:34-36)
PHASE2_AUX = {"ar": ("lta", "pnr"), "oscc": ("ar", "lta", "pnr"),
              "lta": ("ar", "pnr"), "pnr": ("ar", "lta")}


def build_system(hidden: int, tp_hidden: int, feat_dim: int,
                 num_segments: int = 3, tp_dropout: float = 0.5, *,
                 compute_dtype: torch.dtype = torch.float32,
                 fused_layout: Optional[str] = None, phase2: bool = False,
                 propagate_dtype: Any = None,
                 device: DeviceLike = None) -> MultiTaskSystem:
    """Backbone (TRN pooling + 3 SAGE layers) and the four heads; with
    ``phase2`` each head also carries its aux classifier set;
    ``propagate_dtype`` as for ``TemporalGraph``. Parameters are zeros until
    ``init_params`` or ``load_state``."""
    dev = resolve_device(device)
    pooling = TRNPooling(feat_dim, hidden, num_segments, hidden_size=tp_hidden,
                         dropout=tp_dropout, dtype=propagate_dtype, device=dev)
    backbone = TemporalGraph(feat_dim, hidden, depth=3,
                             temporal_pooling=pooling,
                             num_segments=num_segments,
                             propagate_dtype=propagate_dtype, device=dev)
    aux = PHASE2_AUX if phase2 else {t: None for t in PHASE2_AUX}
    heads = {
        "ar": RecognitionTask("ar", hidden, hidden, heads=(N_VERBS, N_NOUNS),
                              aux_tasks=aux["ar"], device=dev),
        "oscc": OSCCTask("oscc", hidden, hidden, aux_tasks=aux["oscc"],
                         device=dev),
        "lta": LTATask("lta", hidden, hidden, heads=(N_VERBS, N_NOUNS),
                       aux_tasks=aux["lta"], device=dev),
        "pnr": PNRTask("pnr", hidden, hidden, aux_tasks=aux["pnr"],
                       device=dev),
    }
    specs = {"ar": G.ar_spec(9, 1.0), "oscc": G.oscc_spec(1.0),
             "lta": G.lta_spec(2, 20, 1.0), "pnr": G.pnr_spec(16, 1.0)}
    tasks = {n: TaskSetup(n, heads[n], specs[n], 1.0,
                          append_node="avg" if n == "lta" else None)
             for n in heads}
    return MultiTaskSystem(backbone, tasks, compute_dtype, fused_layout,
                           device=dev)


def synthetic_batches(system: MultiTaskSystem, batch: int, feat_dim: int,
                      num_segments: int = 3, seed: int = 0,
                      names: Optional[Sequence[str]] = None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Production-layout batches on the system's device, drawn with numpy
    exactly as the JAX entry draws them: LTA ships its 2 input clips, PNR
    un-repeated frames. ``names`` stops after the last named task (the
    draws of the tasks before it are made all the same)."""
    rng = np.random.default_rng(seed)
    out = {}
    order = list(system.tasks)
    if names is not None:
        order = order[:max(order.index(n) for n in names) + 1]
    for name in order:
        setup = system.tasks[name]
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
    if names is not None:
        out = {n: out[n] for n in names}
    return to_device(out, system.device)


def to_device(batches: Dict[str, Dict[str, np.ndarray]],
              device: DeviceLike = None) -> Dict[str, Dict[str, torch.Tensor]]:
    dev = resolve_device(device)
    return {name: {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            for name, b in batches.items()}


def make_device_batch_gen(system: MultiTaskSystem, batch: int, feat_dim: int,
                          num_segments: int = 3
                          ) -> Callable[[int], Dict[str, Dict[str,
                                                            torch.Tensor]]]:
    """``gen(seed) -> {task: batch}`` drawn on the system's device from a
    seeded ``torch.Generator`` there (``__graft_entry__.py:90-135``): the
    shapes, dtypes, layouts and label ranges of :func:`synthetic_batches`,
    LTA's strict ``y > 0`` verbs included, without a copy from the host.
    The draws are not JAX's; the bench times them and compares nothing."""
    dev = system.device
    sizes = {n: system.tasks[n].spec.num_nodes for n in sorted(system.tasks)}

    def gen(seed: int) -> Dict[str, Dict[str, torch.Tensor]]:
        g = make_generator(seed, dev)

        def randint(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=g, device=dev,
                                 dtype=torch.int32)

        out = {}
        for name, n in sizes.items():
            if name == "lta":
                shape = (batch, 2, num_segments, feat_dim)
            elif name == "pnr":
                shape = (batch, n, feat_dim)
            else:
                shape = (batch, n, num_segments, feat_dim)
            x = torch.randn(shape, generator=g, device=dev)
            if name == "oscc":
                y = randint(0, 2, (batch,))
            elif name == "pnr":
                y = torch.nn.functional.one_hot(
                    randint(0, n, (batch,)).long(), n).to(torch.int32)
            else:
                y = torch.full((batch, n, 2), -1, dtype=torch.int32,
                               device=dev)
                if name == "ar":
                    y[:, n // 2, 0] = randint(0, N_VERBS, (batch,))
                    y[:, n // 2, 1] = randint(0, N_NOUNS, (batch,))
                else:  # lta: verbs from 1, the reference's y > 0 quirk
                    y[:, 2:, 0] = randint(1, N_VERBS, (batch, n - 2))
                    y[:, 2:, 1] = randint(0, N_NOUNS, (batch, n - 2))
            out[name] = {"x": x, "y": y,
                         "valid": torch.ones(batch, dtype=torch.bool,
                                             device=dev)}
        return out

    return gen


def _batch_groups(system: MultiTaskSystem, batch: int, feat_dim: int,
                  names: Sequence[str], steps_per_call: int, seed: int,
                  device_batches: bool):
    """One batch group (``steps_per_call`` 1) or a list of them: group k
    from seed ``seed + k``, by numpy on the host or on the card."""
    gen = make_device_batch_gen(system, batch, feat_dim) if device_batches \
        else None
    groups = []
    for k in range(steps_per_call):
        if gen is not None:
            b = gen(seed + k)
        else:
            b = synthetic_batches(system, batch, feat_dim, seed=seed + k,
                                  names=names)
        groups.append({n: b[n] for n in names})
    return groups[0] if steps_per_call == 1 else groups


Batches = Union[Dict[str, Dict[str, torch.Tensor]],
                List[Dict[str, Dict[str, torch.Tensor]]]]


def _run_groups(batches: Batches, log_norms,
                call: Callable[..., Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """``call(group, log_norms)`` on one batch group, with the step's own
    ``log_norms``; on a list of K groups, K steps in turn, their logs
    stacked on a leading K axis. Under ``log_norms="last"`` only the last
    step logs the global norms, as unstacked scalars."""
    if not isinstance(batches, list):
        return call(batches, None)
    k = len(batches)
    steps = [call(b, norms_due(log_norms, i, k, k))
             for i, b in enumerate(batches)]
    logs = {key: torch.stack([l[key] for l in steps]) for key in steps[0]}
    logs.update({key: v for key, v in steps[-1].items() if key not in logs})
    return logs


@dataclass
class MTLStep:
    system: MultiTaskSystem
    optimizer: topt.Adam
    opt_state: topt.AdamState
    step: Callable
    batches: Batches  # one group, or a list of steps_per_call groups
    generator: torch.Generator
    log_norms: Any = True

    def __call__(self, lr: float = 1e-5) -> Dict[str, torch.Tensor]:
        return _run_groups(self.batches, self.log_norms, lambda b, norms:
                           self.step(self.opt_state, b, self.generator, lr,
                                     log_norms=norms))


def build_mtl_step(batch: int = 16, feat_dim: int = 1536, hidden: int = 1024,
                   *, impl: str = "fused", moments_dtype: str = "float32",
                   compute_dtype: torch.dtype = torch.float32,
                   propagate_dtype: Any = None,
                   fused_layout: Optional[str] = None,
                   tp_dropout: float = 0.5,
                   active: Tuple[str, ...] = ACTIVE, log_norms=True,
                   steps_per_call: int = 1, device_batches: bool = False,
                   seed: int = 0, device: DeviceLike = None) -> MTLStep:
    """The phase-1 AR+LTA+PNR train step at the bench configuration
    (hidden 1024, feat 1536, batch 16 per task by default), Adam(1e-5,
    wd 1e-5) over the driver's trainable mask. ``log_norms``: True, False
    or ``"last"`` (the last of the ``steps_per_call`` steps only)."""
    dev = resolve_device(device)
    system = build_system(hidden, hidden, feat_dim, tp_dropout=tp_dropout,
                          compute_dtype=compute_dtype,
                          propagate_dtype=propagate_dtype,
                          fused_layout=fused_layout, device=dev)
    generator = make_generator(seed, dev)
    system.init_params(generator)
    mask = topt.trainable_mask_fn(["temporal_graph"]
                                  + [CKPT_KEYS[t] for t in active])
    optimizer = topt.adam(1e-5, 1e-5, trainable_mask=mask,
                          moments_dtype=moments_dtype, impl=impl)
    opt_state = optimizer.init(system.params())
    step = system.make_train_step(optimizer, active, log_norms=log_norms)
    batches = _batch_groups(system, batch, feat_dim, active, steps_per_call,
                            seed, device_batches)
    return MTLStep(system, optimizer, opt_state, step, batches, generator,
                   log_norms)


# ---------------- phase 2: the novel-OSCC EgoPack step ----------------

AUX_TASKS = ("ar", "lta", "pnr")


def random_banks(p_pad: int, fill: int, hidden: int,
                 device: DeviceLike = None) -> Dict[str, PrototypeBank]:
    """Seeded normal banks for the aux tasks, the first ``fill`` of
    ``p_pad`` rows valid (the bench's stand-in for banks built from data,
    ``bench.py:312-321``)."""
    rng = np.random.default_rng(3)
    dev = resolve_device(device)
    mask = torch.as_tensor(np.arange(p_pad) < fill, device=dev)
    return {t: PrototypeBank(torch.as_tensor(
        rng.normal(size=(p_pad, hidden)).astype(np.float32), device=dev), mask)
        for t in AUX_TASKS}


def prototype_banks(system: MultiTaskSystem,
                    ar_batches: Iterable[Dict[str, torch.Tensor]]
                    ) -> Dict[str, PrototypeBank]:
    """The aux tasks' banks from a sweep over AR batches with the system's
    current weights (``train/driver.py:580-596``), on the system's
    device."""
    step = make_prototype_step(system, AUX_TASKS, N_VERBS, N_NOUNS)
    return build_prototypes(step, ar_batches, N_VERBS, N_NOUNS,
                            n_tasks=len(AUX_TASKS), device=system.device)


@dataclass
class EgoPackStep:
    system: MultiTaskSystem
    graphone: GraphONE
    banks: Dict[str, PrototypeBank]
    optimizer: topt.Adam
    opt_state: topt.AdamState
    step: Callable
    batches: Batches
    generator: torch.Generator
    log_norms: Any = True

    def __call__(self, lr: float = 1e-6) -> Dict[str, torch.Tensor]:
        return _run_groups(self.batches, self.log_norms, lambda b, norms:
                           self.step(self.opt_state, self.banks, b,
                                     self.generator, lr, log_norms=norms))


def build_egopack_step(batch: int = 16, feat_dim: int = 1536,
                       hidden: int = 1024, *,
                       loaded: Optional[Dict[str, torch.Tensor]] = None,
                       banks: Optional[Dict[str, PrototypeBank]] = None,
                       proto_batches: Optional[Iterable[Dict[str,
                                                             torch.Tensor]]]
                       = None, p_pad: int = 2048, fill: int = 1900,
                       compute_dtype: torch.dtype = torch.float32,
                       propagate_dtype: Any = None,
                       moments_dtype: str = "float32", log_norms=True,
                       steps_per_call: int = 1, device_batches: bool = False,
                       seed: int = 0, device: DeviceLike = None
                       ) -> EgoPackStep:
    """The phase-2 novel-OSCC EgoPack step at the bench configuration
    (``bench.py:build_egopack_step``): aux tasks AR, LTA, PNR; frozen banks;
    GraphONE k=8, depth 3, no residual, the kNN kernel on the card;
    Adam(1e-6, wd 1e-5) with ``impl="fused"`` over ``temporal_graph``,
    ``task/oscc`` and ``graphone``; backprop into the backbone, backbone in
    eval mode, late fusion.

    ``loaded``: a phase-1 torch state merged in with
    ``merge_loaded_params``. Banks: ``banks`` as given, else built from
    ``proto_batches`` (AR batches) with the merged weights, else seeded
    random banks of ``p_pad`` rows with ``fill`` valid."""
    dev = resolve_device(device)
    system = build_system(hidden, hidden, feat_dim, phase2=True,
                          compute_dtype=compute_dtype,
                          propagate_dtype=propagate_dtype, device=dev)
    generator = make_generator(seed, dev)
    system.init_params(generator)
    if loaded is not None:
        fresh = system.model.state_dict()
        system.load_state(merge_loaded_params(
            fresh, {n: v.to(dev) for n, v in loaded.items()}))
    if banks is None:
        banks = (prototype_banks(system, proto_batches)
                 if proto_batches is not None
                 else random_banks(p_pad, fill, hidden, device=dev))
    graphone = GraphONE(AUX_TASKS, features_size=hidden, hidden_size=hidden,
                        k=8, depth=3, residual=False, device=dev)
    graphone.reset_parameters(make_generator(seed + 2, dev))
    system.attach_graphone(graphone)
    trainable = ["temporal_graph", CKPT_KEYS["oscc"], "graphone"]
    optimizer = topt.adam(1e-6, 1e-5,
                          trainable_mask=topt.trainable_mask_fn(trainable),
                          moments_dtype=moments_dtype, impl="fused")
    opt_state = optimizer.init(system.params())
    step = system.make_egopack_train_step(
        optimizer, ("oscc",), graphone, backprop_temporal_graph=True,
        temporal_graph_train_mode=False, late_fusion=True,
        log_norms=log_norms)
    batches = _batch_groups(system, batch, feat_dim, ("oscc",),
                            steps_per_call, seed, device_batches)
    return EgoPackStep(system, graphone, banks, optimizer, opt_state, step,
                       batches, generator, log_norms)
