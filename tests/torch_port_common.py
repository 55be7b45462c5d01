"""Shared pieces of the ``test_torch_port_*`` tests: the JAX reference
system at a small size and the conversions between its numpy-leaved trees
and the port's tensors."""

import jax
import numpy as np
import torch

import __graft_entry__ as ge
from egopack_torch import entry as tentry
from egopack_torch import interop

FEAT, HIDDEN, BATCH = 16, 32, 2
ACTIVE = ("ar", "lta", "pnr")

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
