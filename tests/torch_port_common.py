"""Shared pieces of the ``test_torch_port_*`` tests: the JAX reference
systems (phase 1 and phase 2) at a small size and the conversions between
their numpy-leaved trees and the port's tensors."""

import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as ge
from egopack_torch import entry as tentry
from egopack_torch import interop
from egopack_torch.models import graphone as tgraphone
from egopack_torch.models.heads import RecognitionTask
from egopack_torch.train.system import MultiTaskSystem
from egopack_tpu.models import graphone as jgraphone
from egopack_tpu.train.driver import PHASE2_AUX as PUBLISHED_AUX

FEAT, HIDDEN, BATCH = 16, 32, 2
ACTIVE = ("ar", "lta", "pnr")
AUX = ("ar", "lta", "pnr")
P_PAD, FILL = 128, 100  # phase-2 test banks: 100 valid rows of 128

# f32 tolerances: losses rtol 1e-5; layers, modules and gradients
# rtol 1e-4 / atol 1e-5 (sums run in another order in the two frameworks)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MODULE_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_UNIT = 2.0 ** -7  # one unit in the last place of a bf16 in [1, 2)


def to_np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def to_torch(a):
    return torch.from_numpy(np.array(a))


def close(torch_value, jax_value, **tol):
    np.testing.assert_allclose(torch_value.detach().numpy(),
                               np.asarray(jax_value), **tol)


def jax_system(fused_layout="auto"):
    """The JAX phase-1 system at the small test width, dropout off."""
    system = ge._build_system(HIDDEN, HIDDEN, FEAT, tp_dropout=0.0)
    system.fused_layout = fused_layout
    params = system.init_params(jax.random.PRNGKey(0), FEAT)
    return system, params


def torch_system(jax_params, fused_layout="auto",
                 compute_dtype=torch.float32):
    """The port's system on the CPU, carrying the JAX weights."""
    system = tentry.build_system(HIDDEN, HIDDEN, FEAT, tp_dropout=0.0,
                                 compute_dtype=compute_dtype,
                                 fused_layout=fused_layout, device="cpu")
    system.load_state(interop.from_flax(to_np(jax_params)))
    return system


def batches(jax_system_, seed=0):
    """The same synthetic batches for both: (jax dict, torch dict)."""
    jb = ge._synthetic_batches(jax_system_, BATCH, FEAT, seed=seed)
    tb = tentry.to_device(to_np(jb), "cpu")
    return jb, tb


def numpy_banks(seed=5, p_pad=P_PAD, fill=FILL, dim=HIDDEN, tasks=AUX):
    """{task: (values (p_pad, dim) f32, mask (p_pad,) bool)} from a seed."""
    rng = np.random.default_rng(seed)
    return {t: (rng.normal(size=(p_pad, dim)).astype(np.float32),
                np.arange(p_pad) < fill) for t in tasks}


def jax_banks(banks):
    return {t: jgraphone.PrototypeBank(jnp.asarray(v), jnp.asarray(m))
            for t, (v, m) in banks.items()}


def torch_banks(banks):
    return {t: tgraphone.PrototypeBank(torch.from_numpy(v.copy()),
                                       torch.from_numpy(m.copy()))
            for t, (v, m) in banks.items()}


def jax_phase2(banks, k=8, freeze=True, residual=False, head_aux=None):
    """The JAX phase-2 system at the small width (dropout off), its
    GraphONE over the banks' tasks, and the params with the ``graphone``
    subtree (and ``graphone_banks`` when not frozen). ``head_aux`` gives
    each head's aux classifier set (default: the entry's narrow sets;
    :data:`PUBLISHED_AUX` for the published ones)."""
    system = ge._build_system(HIDDEN, HIDDEN, FEAT, phase2=True,
                              tp_dropout=0.0)
    if head_aux is not None:
        for name, setup in system.tasks.items():
            setup.head = setup.head.clone(aux_tasks=tuple(head_aux[name]))
    params = system.init_params(jax.random.PRNGKey(0), FEAT)
    tasks = tuple(banks)
    graphone = jgraphone.GraphONE(task_labels=tasks, features_size=HIDDEN,
                                  hidden_size=HIDDEN, k=k, depth=3,
                                  residual=residual, freeze=freeze,
                                  knn_impl="xla")
    jb = jax_banks(banks)
    feats0 = {t: jnp.zeros((4, HIDDEN)) for t in tasks}
    params["graphone"] = graphone.init(jax.random.PRNGKey(2), feats0, jb,
                                       method="interact")["params"]
    if not freeze:
        params["graphone_banks"] = {t: jnp.array(jb[t].values)
                                    for t in tasks}
    return system, graphone, params, jb


def torch_phase2(jax_params, banks, k=8, freeze=True, residual=False,
                 head_aux=None):
    """The port's phase-2 system on the CPU with the JAX weights, its
    GraphONE over the banks' tasks attached, and the banks; ``head_aux`` as
    for :func:`jax_phase2`."""
    system = tentry.build_system(HIDDEN, HIDDEN, FEAT, tp_dropout=0.0,
                                 phase2=True, device="cpu")
    if head_aux is not None:
        for name, setup in system.tasks.items():
            extra = ({"heads": (tentry.N_VERBS, tentry.N_NOUNS)}
                     if isinstance(setup.head, RecognitionTask) else {})
            setup.head = type(setup.head)(name, HIDDEN, HIDDEN,
                                          aux_tasks=head_aux[name],
                                          device="cpu", **extra)
        system = MultiTaskSystem(system.backbone, system.tasks,
                                 device="cpu")
    tb = torch_banks(banks)
    graphone = tgraphone.GraphONE(tuple(banks), features_size=HIDDEN,
                                  hidden_size=HIDDEN, k=k, depth=3,
                                  residual=residual, freeze=freeze,
                                  device="cpu")
    system.attach_graphone(graphone, None if freeze else tb)
    system.load_state(interop.from_flax(to_np(jax_params)))
    return system, graphone, tb


# ---- the drivers' records ----

def records(run_dir):
    with open(osp.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def by_epoch(recs, prefix):
    out = {}
    for r in recs:
        vals = {k: v for k, v in r.items() if k.startswith(prefix)}
        if vals:
            out.setdefault(r["step"], {}).update(vals)
    return out


def assert_train_records_match(ours, ref, rtol):
    """Two driver runs' per-epoch ``train/`` records (losses, norms): the
    same keys for epochs 1 and 2, the values at ``rtol``."""
    ours = by_epoch(records(ours["run_dir"]), "train/")
    ref = by_epoch(records(ref["run_dir"]), "train/")
    assert sorted(ours) == sorted(ref) == [1, 2]
    for epoch in ref:
        assert set(ours[epoch]) == set(ref[epoch])
        for k, v in ref[epoch].items():
            np.testing.assert_allclose(ours[epoch][k], v, rtol=rtol,
                                       atol=1e-7, err_msg=f"epoch {epoch} {k}")
    return ref


def assert_counts_agree(ours, ref, tol, what=""):
    """Two histograms ``(counts, edges)`` of values that differ by at most
    ``tol`` each: the totals are equal, and below each of our edges ``e``
    we count no fewer values than the reference has below ``e - tol`` and
    no more than it has below ``e + tol`` (read at its own edges, which
    bounds them from outside)."""
    (oc, oe), (rc, re) = ours, ref
    assert oc.sum() == rc.sum(), what
    below_o = np.concatenate([[0], np.cumsum(oc)])
    below_r = np.concatenate([[0], np.cumsum(rc)])
    for i in range(1, len(oe) - 1):
        j = np.searchsorted(re, oe[i] - tol, side="right") - 1
        k = np.searchsorted(re, oe[i] + tol, side="left")
        lo = below_r[j] if j >= 0 else 0
        hi = below_r[k] if k < len(re) else rc.sum()
        assert lo <= below_o[i] <= hi, (what, i, lo, below_o[i], hi)


def assert_histogram_files_match(ours_dir, ref_dir, epochs):
    """Both packages' snapshots: the same arrays; parameters and
    gradients agree at rtol 1e-4 / atol 1e-5, so the edges do and the
    counts agree within that tolerance (``assert_counts_agree``)."""
    for epoch in epochs:
        name = f"histograms_ep{epoch}.npz"
        with np.load(osp.join(ours_dir, name)) as o, \
                np.load(osp.join(ref_dir, name)) as r:
            assert set(o.files) == set(r.files) and r.files
            for key in r.files:
                assert o[key].dtype == r[key].dtype == np.float32, key
                if not key.endswith(":counts"):
                    continue
                stem = key[:-len(":counts")]
                re = r[stem + ":edges"]
                tol = 1e-4 * np.abs(re).max() + 1e-5
                np.testing.assert_allclose(o[stem + ":edges"], re, rtol=0,
                                           atol=tol, err_msg=stem)
                assert_counts_agree((o[key], o[stem + ":edges"]),
                                    (r[key], re), tol, stem)
