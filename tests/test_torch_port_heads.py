"""The port's task heads against the flax heads of ``egopack_tpu.models.heads``
(``project`` and ``forward_logits``) with the same weights and inputs.
Tolerance: rtol 1e-4 / atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egopack_tpu.train.system import CKPT_KEYS
from torch_port_common import (HIDDEN, MODULE_TOL, close, jax_system,
                               torch_system)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["ar", "lta", "oscc", "pnr"])
def test_project_and_logits(name):
    jsys, params = jax_system()
    tsys = torch_system(params)
    jhead, thead = jsys.tasks[name].head, tsys.tasks[name].head
    p = {"params": params[CKPT_KEYS[name]]}
    n = jsys.tasks[name].spec.num_nodes
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, n, HIDDEN)).astype(np.float32)
    mask = np.ones((3, n), bool)
    mask[1, n // 2:] = False  # padded nodes (OSCC pools over valid ones)

    jf = jhead.apply(p, jnp.asarray(x), method="forward_features")
    tf = thead.forward_features(torch.from_numpy(x))
    close(tf, jf, **MODULE_TOL)
    if name == "oscc":
        ref = jhead.apply(p, jf, jnp.asarray(mask), method="forward_logits")
        ours = thead.forward_logits(tf, torch.from_numpy(mask))
    else:
        ref = jhead.apply(p, jf, method="forward_logits")
        ours = thead.forward_logits(tf)
    if isinstance(ref, tuple):
        assert len(ours) == len(ref) == 2
        for o, r in zip(ours, ref):
            close(o, r, **MODULE_TOL)
    else:
        assert tuple(ours.shape) == ref.shape
        close(ours, ref, **MODULE_TOL)
