"""Per-layer norms and per-parameter histograms against the JAX package
(``egopack_tpu/train/system.py:82-116``, ``:434-556``, ``:687-745``), on
the same weights and batches, dropout off.

- per-layer norms: the key sets equal JAX's letter for letter (the flax
  tree's first two levels rebuilt from the port's names) and the values
  agree at rtol 1e-5, for the phase-1 step, two phase-1 steps under
  ``log_norms="last"`` (against JAX's multi-step) and the phase-2 step;
  frozen subtrees read 0 on both sides.
- ``histogram`` against ``jnp.histogram`` on the same values: counts
  equal, edges within rtol 1e-6 of the largest edge's magnitude (an edge
  ``lo * (1 - s) + hi * s`` near zero keeps the rounding error of its
  terms; XLA may fuse the multiply-add), a constant leaf included.
- ``make_histogram_fn`` against JAX's: the same keys; weight histograms
  (the same values) with equal counts; gradient histograms, whose values
  agree at rtol 1e-4 / atol 1e-5 (f32 sums in another order), with edges
  within that tolerance and counts that differ only by the values that
  lie that close to an edge (``assert_counts_agree``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egopack_tpu.train import optim as jopt
from egopack_tpu.train.driver import CKPT_KEYS, trainable_mask_fn as j_mask
from egopack_torch.entry import synthetic_batches
from egopack_torch.train import optim as topt
from egopack_torch.train import system as tsystem
from torch_port_common import (ACTIVE, BATCH, FEAT, assert_counts_agree,
                               batches, jax_phase2, jax_system, numpy_banks,
                               to_np, torch_phase2, torch_system)

torch.set_num_threads(1)

LR = 1e-3
NORM_TOL = dict(rtol=1e-5, atol=1e-7)
TRAINABLE = ["temporal_graph"] + [CKPT_KEYS[t] for t in ACTIVE]
PHASE2_TRAINABLE = ["temporal_graph", CKPT_KEYS["oscc"], "graphone"]


def _norm_keys(logs):
    return {k: v for k, v in logs.items() if "_norm/" in k}


def _assert_norms_match(tlogs, jlogs):
    ours, ref = _norm_keys(tlogs), _norm_keys(jlogs)
    assert set(ours) == set(ref) and ref, sorted(set(ours) ^ set(ref))
    for key, v in ref.items():
        np.testing.assert_allclose(ours[key].detach().numpy(), np.asarray(v),
                                   err_msg=key, **NORM_TOL)
    return ours


def _optimizers(trainable):
    jo = jopt.adam(LR, 1e-5, trainable_mask=j_mask(trainable), impl="fused")
    to = topt.adam(LR, 1e-5, impl="fused",
                   trainable_mask=topt.trainable_mask_fn(trainable))
    return jo, to


def test_per_layer_norms_phase1_match_jax():
    jsys, params = jax_system("concat")
    tsys = torch_system(params, "concat")
    jb, tb = batches(jsys)
    jo, to = _optimizers(TRAINABLE)
    jstep = jsys.make_train_step(jo, ACTIVE, per_layer_norms=True)
    _, _, jl = jstep(params, jo.init(params), jb, jax.random.PRNGKey(0), LR)
    tl = tsys.make_train_step(to, ACTIVE, per_layer_norms=True)(
        to.init(tsys.params()), tb, None, LR)
    ours = _assert_norms_match(tl, jl)
    # the frozen OSCC head: no gradient in either package
    assert float(ours["grad_norm/task/oscc/proj_fc0"]) == 0.0
    assert float(ours["param_norm/task/oscc/proj_fc0"]) > 0.0
    assert "grad_norm/temporal_graph/pooling" in ours


def test_per_layer_norms_multi_step_last_match_jax():
    """``log_norms="last"``: JAX's multi-step against two calls of the
    port's one step, the first with ``log_norms=False`` and the second with
    True, as the drivers' ``norms_due`` makes them; the per-layer norms on
    both calls, the global ones on the second only."""
    jsys, params = jax_system("concat")
    tsys = torch_system(params, "concat")
    groups = [synthetic_batches(tsys, BATCH, FEAT, seed=s) for s in (1, 2)]
    tgroups = [{n: g[n] for n in ACTIVE} for g in groups]
    jgroups = tuple({n: {k: jnp.asarray(v.numpy()) for k, v in g[n].items()}
                     for n in ACTIVE} for g in groups)
    jo, to = _optimizers(TRAINABLE)
    jmulti = jsys.make_train_step_multi(jo, ACTIVE, 2, log_norms="last",
                                        per_layer_norms=True)
    # fold_in(key, 0 + k) for step k, ignored with dropout off
    _, _, jl = jmulti(params, jo.init(params), jgroups,
                      jax.random.PRNGKey(0), 0, LR)
    step = tsys.make_train_step(to, ACTIVE, log_norms="last",
                                per_layer_norms=True)
    state = to.init(tsys.params())
    first, last = (step(state, g, None, LR, log_norms=due)
                   for g, due in zip(tgroups, (False, True)))
    assert "grad_norm" not in first and last["grad_norm"].shape == ()
    tl = {k: torch.stack([first[k], last[k]]) for k in _norm_keys(last)}
    ours = _assert_norms_match(tl, jl)
    assert ours["grad_norm/temporal_graph/sage0"].shape == (2,)
    assert np.asarray(jl["grad_norm"]).shape == ()
    np.testing.assert_allclose(float(last["grad_norm"]),
                               float(jl["grad_norm"]), rtol=1e-4)


def test_per_layer_norms_phase2_match_jax():
    nb = numpy_banks()
    jsys, graphone, params, jbanks = jax_phase2(nb)
    tsys, tgraphone, tbanks = torch_phase2(to_np(params), nb)
    jb, tb = batches(jsys)
    jo, to = _optimizers(PHASE2_TRAINABLE)
    kw = dict(backprop_temporal_graph=True, temporal_graph_train_mode=False,
              late_fusion=True, per_layer_norms=True)
    jstep = jsys.make_egopack_train_step(jo, ("oscc",), graphone, **kw)
    _, _, jl = jstep(params, jo.init(params), jbanks, {"oscc": jb["oscc"]},
                     jax.random.PRNGKey(0), LR)
    tl = tsys.make_egopack_train_step(to, ("oscc",), tgraphone, **kw)(
        to.init(tsys.params()), tbanks, {"oscc": tb["oscc"]}, None, LR)
    ours = _assert_norms_match(tl, jl)
    assert float(ours["grad_norm/graphone"]) > 0.0
    assert float(ours["grad_norm/task/recognition/proj_fc0"]) == 0.0


def _jax_hist(values, bins=64):
    counts, edges = jnp.histogram(jnp.asarray(values, jnp.float32).ravel(),
                                  bins=bins)
    return np.asarray(counts), np.asarray(edges)


@pytest.mark.parametrize("case", ["normal", "zeros", "constant", "ties",
                                  "wide"])
def test_histogram_matches_jnp(case):
    rng = np.random.default_rng(3)
    values = {"normal": rng.normal(size=(33, 17)),
              "zeros": np.zeros((7, 5)),
              "constant": np.full(11, 3.25),
              "ties": rng.integers(-4, 5, size=500),  # values on edges
              "wide": rng.normal(size=4096) * 1e3 + 5.0}[case]
    values = values.astype(np.float32)
    counts, edges = tsystem.histogram(torch.from_numpy(values))
    ref_counts, ref_edges = _jax_hist(values)
    assert counts.dtype == torch.float32 and counts.shape == (64,)
    assert edges.shape == (65,)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    np.testing.assert_allclose(edges.numpy(), ref_edges, rtol=1e-6,
                               atol=1e-6 * np.abs(ref_edges).max())
    assert counts.sum() == values.size


def _assert_hists_match(ours, ref):
    assert set(ours) == set(ref), sorted(set(ours) ^ set(ref))
    for key, (rc, re) in ref.items():
        oc, oe = (t.numpy() for t in ours[key])
        rc, re = np.asarray(rc), np.asarray(re)
        if key.startswith("param_hist/"):
            np.testing.assert_array_equal(oc, rc, err_msg=key)
            np.testing.assert_allclose(oe, re, rtol=1e-6,
                                       atol=1e-6 * np.abs(re).max(),
                                       err_msg=key)
            continue
        tol = 1e-4 * np.abs(re).max() + 1e-5
        np.testing.assert_allclose(oe, re, rtol=0, atol=tol, err_msg=key)
        assert_counts_agree((oc, oe), (rc, re), tol, key)


@pytest.mark.parametrize("phase", [1, 2])
def test_histogram_fn_matches_jax(phase):
    if phase == 1:
        jsys, params = jax_system("concat")
        tsys = torch_system(params, "concat")
        jb, tb = batches(jsys)
        ref = jsys.make_histogram_fn(ACTIVE)(params, jb,
                                             jax.random.PRNGKey(0))
        ours = tsys.make_histogram_fn(ACTIVE)(tb, None)
    else:
        nb = numpy_banks()
        jsys, graphone, params, jbanks = jax_phase2(nb)
        tsys, tgraphone, tbanks = torch_phase2(to_np(params), nb)
        jb, tb = batches(jsys)
        ref = jsys.make_histogram_fn(("oscc",), graphone=graphone)(
            params, jbanks, {"oscc": jb["oscc"]}, jax.random.PRNGKey(0))
        ours = tsys.make_histogram_fn(("oscc",), graphone=tgraphone)(
            tbanks, {"oscc": tb["oscc"]}, None)
    _assert_hists_match(ours, ref)
    frozen = "grad_hist/task/oscc/cls/TLinear_0/kernel" if phase == 1 else \
        "grad_hist/task/recognition/cls0/TLinear_0/kernel"
    counts, edges = ours[frozen]
    assert float(edges[0]) == -0.5 and float(edges[-1]) == 0.5
    assert int(counts[32]) == int(counts.sum())  # all zeros, middle bin
