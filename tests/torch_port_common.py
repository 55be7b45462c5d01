"""Shared pieces of the ``test_torch_port_*`` tests: the JAX reference
systems (phase 1 and phase 2) at a small size and the conversions between
their numpy-leaved trees and the port's tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as ge
from egopack_torch import entry as tentry
from egopack_torch import interop
from egopack_torch.models import graphone as tgraphone
from egopack_tpu.models import graphone as jgraphone

FEAT, HIDDEN, BATCH = 16, 32, 2
ACTIVE = ("ar", "lta", "pnr")
AUX = ("ar", "lta", "pnr")
P_PAD, FILL = 128, 100  # phase-2 test banks: 100 valid rows of 128

# f32 tolerances: losses rtol 1e-5; layers, modules and gradients
# rtol 1e-4 / atol 1e-5 (sums run in another order in the two frameworks)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MODULE_TOL = dict(rtol=1e-4, atol=1e-5)


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


def jax_phase2(banks, k=8, freeze=True, residual=False):
    """The JAX phase-2 system at the small width (dropout off), its
    GraphONE over the aux tasks, and the params with the ``graphone``
    subtree (and ``graphone_banks`` when not frozen)."""
    system = ge._build_system(HIDDEN, HIDDEN, FEAT, phase2=True,
                              tp_dropout=0.0)
    params = system.init_params(jax.random.PRNGKey(0), FEAT)
    graphone = jgraphone.GraphONE(task_labels=AUX, features_size=HIDDEN,
                                  hidden_size=HIDDEN, k=k, depth=3,
                                  residual=residual, freeze=freeze,
                                  knn_impl="xla")
    jb = jax_banks(banks)
    feats0 = {t: jnp.zeros((4, HIDDEN)) for t in AUX}
    params["graphone"] = graphone.init(jax.random.PRNGKey(2), feats0, jb,
                                       method="interact")["params"]
    if not freeze:
        params["graphone_banks"] = {t: jnp.array(jb[t].values) for t in AUX}
    return system, graphone, params, jb


def torch_phase2(jax_params, banks, k=8, freeze=True, residual=False):
    """The port's phase-2 system on the CPU with the JAX weights, its
    GraphONE attached, and the banks."""
    system = tentry.build_system(HIDDEN, HIDDEN, FEAT, tp_dropout=0.0,
                                 phase2=True, device="cpu")
    tb = torch_banks(banks)
    graphone = tgraphone.GraphONE(AUX, features_size=HIDDEN,
                                  hidden_size=HIDDEN, k=k, depth=3,
                                  residual=residual, freeze=freeze,
                                  device="cpu")
    system.attach_graphone(graphone, None if freeze else tb)
    system.load_state(interop.from_flax(to_np(jax_params)))
    return system, graphone, tb
