"""The port's GraphONE (``egopack_torch/models/graphone.py``) against
``egopack_tpu.models.graphone``: the interaction (forward and gradients),
the bank finalisation and the prototype sweep, from the same numpy inputs
and weights. Tolerance rtol 1e-4 / atol 1e-5 (float32 sums in another
order); indices exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egopack_torch import entry as tentry
from egopack_torch.models import graphone as tg
from egopack_tpu.models import graphone as jg
from torch_port_common import (AUX, BATCH, FEAT, HIDDEN, MODULE_TOL, close,
                               jax_banks, jax_system, numpy_banks, to_np,
                               torch_banks, torch_system)
import __graft_entry__ as ge

torch.set_num_threads(1)

M = 12


def _pair(k=4, residual=False, share_params=False, freeze=True,
          hidden=24):
    banks = numpy_banks(seed=9, p_pad=128, fill=90, dim=HIDDEN)
    jgo = jg.GraphONE(task_labels=AUX, features_size=HIDDEN,
                      hidden_size=hidden, k=k, depth=3, residual=residual,
                      share_params=share_params, freeze=freeze,
                      knn_impl="xla")
    jb = jax_banks(banks)
    params = jgo.init(jax.random.PRNGKey(1),
                      {t: jnp.zeros((4, HIDDEN)) for t in AUX}, jb,
                      method="interact")["params"]
    tgo = tg.GraphONE(AUX, features_size=HIDDEN, hidden_size=hidden, k=k,
                      depth=3, residual=residual, share_params=share_params,
                      freeze=freeze, device="cpu")
    tgo.load_state_dict({n: torch.from_numpy(np.array(v))
                         for n, v in to_np(params).items()})
    return jgo, params, jb, tgo, torch_banks(banks)


def _features(tasks, seed=4):
    rng = np.random.default_rng(seed)
    return {t: rng.normal(size=(M, HIDDEN)).astype(np.float32) for t in tasks}


@pytest.mark.parametrize("residual,share_params,tasks", [
    (False, False, AUX),
    (True, False, AUX),
    (False, True, AUX),
    (False, False, ("pnr", "ar")),   # another order: the row gather
    (True, False, ("lta",)),
])
def test_interact_matches_jax(residual, share_params, tasks):
    jgo, params, jb, tgo, tb = _pair(residual=residual,
                                     share_params=share_params)
    feats = _features(tasks)
    jout, jidx = jgo.apply({"params": params},
                           {t: jnp.asarray(v) for t, v in feats.items()}, jb,
                           method="interact")
    tout, tidx = tgo.interact({t: torch.from_numpy(v)
                               for t, v in feats.items()}, tb)
    assert tuple(tout) == tasks == tuple(jout)
    for t in tasks:
        close(tout[t], jout[t], err_msg=t, **MODULE_TOL)
        np.testing.assert_array_equal(tidx[t].numpy(), np.asarray(jidx[t]))


@pytest.mark.parametrize("freeze", [True, False])
def test_interact_gradients_match_jax(freeze):
    """Gradients of a scalar of the interacted features, to every stage
    parameter and, with ``freeze=False``, to the bank values."""
    jgo, params, jb, tgo, tb = _pair(freeze=freeze)
    feats = _features(AUX, seed=6)
    jfeats = {t: jnp.asarray(v) for t, v in feats.items()}
    wts = np.random.default_rng(2).normal(size=(M, HIDDEN)).astype(np.float32)

    def jloss(p, values):
        banks = {t: jg.PrototypeBank(values[t], jb[t].mask) for t in AUX}
        out, _ = jgo.apply({"params": p}, jfeats, banks, method="interact")
        return sum(jnp.sum(v * wts) for v in out.values())

    jgp, jgb = jax.grad(jloss, argnums=(0, 1))(
        params, {t: jb[t].values for t in AUX})
    values = {t: tb[t].values.clone().requires_grad_() for t in AUX}
    tbanks = {t: tg.PrototypeBank(values[t], tb[t].mask) for t in AUX}
    out, _ = tgo.interact({t: torch.from_numpy(v) for t, v in feats.items()},
                          tbanks)
    loss = sum((v * torch.from_numpy(wts)).sum() for v in out.values())
    names = [n for n, _ in tgo.named_parameters()]
    grads = torch.autograd.grad(loss, [dict(tgo.named_parameters())[n]
                                       for n in names] + list(values.values()),
                                allow_unused=True)
    for n, g in zip(names, grads):
        close(g, jgp[n], err_msg=n, **MODULE_TOL)
    for t, g in zip(AUX, grads[len(names):]):
        if freeze:
            assert g is None and not np.asarray(jgb[t]).any()
        else:
            close(g, jgb[t], err_msg=t, **MODULE_TOL)


def test_init_draws_the_torch_default_bounds():
    tgo = tg.GraphONE(AUX, features_size=40, hidden_size=10, device="cpu")
    tgo.reset_parameters(torch.Generator().manual_seed(0))
    assert tgo.w_l.shape == (3, 3, 40, 10) and tgo.w_proj.shape == (3, 3,
                                                                    10, 40)
    for w, bound in ((tgo.w_l, 40 ** -0.5), (tgo.w_r, 40 ** -0.5),
                     (tgo.w_proj, 10 ** -0.5), (tgo.b_proj, 10 ** -0.5)):
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert torch.equal(tgo.ln_scale, torch.ones(3, 3, 10))
    assert not tgo.ln_bias.any()


def test_finalize_prototypes_matches_jax():
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 3, size=300).astype(np.float64) * 3
    counts[:7] = 0
    sums = {t: rng.normal(size=(300, 20)) for t in AUX}
    jbanks = jg.finalize_prototypes(sums, counts)
    tbanks = tg.finalize_prototypes(sums, counts, device="cpu")
    for t in AUX:
        assert tbanks[t].values.dtype == torch.float32
        np.testing.assert_array_equal(tbanks[t].values.numpy(),
                                      np.asarray(jbanks[t].values))
        np.testing.assert_array_equal(tbanks[t].mask.numpy(),
                                      np.asarray(jbanks[t].mask))
        assert tbanks[t].num_valid == jbanks[t].num_valid
    few = tg.finalize_prototypes({"ar": np.ones((5, 3))},
                                 np.array([0, 1, 0, 2, 0.]), device="cpu")
    assert few["ar"].values.shape == (128, 3) and few["ar"].num_valid == 2


def test_build_prototypes_matches_jax():
    """The sweep over the same AR batches with the same phase-1 weights:
    per-class sums, the n_tasks-inflated counts, the mask and the padding."""
    jsys, params = jax_system()
    tsys = torch_system(params)
    batches = [ge._synthetic_batches(jsys, 16, FEAT, seed=s)["ar"]
               for s in range(3)]
    batches[1]["valid"] = batches[1]["valid"].at[3:].set(False)
    n_verbs, n_nouns = 5, 7
    for b in batches:  # a small taxonomy, so combos repeat
        b["y"] = jnp.where(b["y"] >= 0, b["y"] % jnp.asarray([n_verbs,
                                                              n_nouns]), -1)
    jstep = jg.make_prototype_step(jsys, AUX, n_verbs, n_nouns)
    jbanks = jg.build_prototypes(jstep, params, batches, n_verbs, n_nouns,
                                 n_tasks=3)
    tstep = tg.make_prototype_step(tsys, AUX, n_verbs, n_nouns)
    tb = [tentry.to_device({"ar": to_np(b)}, "cpu")["ar"] for b in batches]
    tbanks = tg.build_prototypes(tstep, tb, n_verbs, n_nouns, n_tasks=3)
    js, jc = jstep(params, batches[0])
    ts, tc = tstep(tb[0])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for t in AUX:
        close(ts[t], js[t], err_msg=t, **MODULE_TOL)
        assert tbanks[t].values.shape == jbanks[t].values.shape
        np.testing.assert_array_equal(tbanks[t].mask.numpy(),
                                      np.asarray(jbanks[t].mask))
        close(tbanks[t].values, jbanks[t].values, err_msg=t, **MODULE_TOL)
    assert 0 < tbanks["ar"].num_valid < 16 + 16 + 3
