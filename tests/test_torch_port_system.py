"""The port's phase-1 multi-task train step against the JAX one: same
weights (carried by ``egopack_torch.interop``), same batches, dropout off.
Tolerances: losses rtol 1e-5; gradients, norms and parameters rtol 1e-4 /
atol 1e-5 (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from egopack_tpu.data import graphs as jgraphs
from egopack_tpu.train import optim as jopt
from egopack_tpu.train.driver import CKPT_KEYS, trainable_mask_fn as j_mask
from egopack_torch import interop
from egopack_torch.data import graphs as tgraphs
from egopack_torch.entry import MTLStep, synthetic_batches
from egopack_torch.train import optim as topt
from egopack_torch.train.system import lta_full_adjacency
from torch_port_common import (ACTIVE, BATCH, FEAT, LOSS_TOL, MODULE_TOL,
                               batches, close, jax_system, to_np, torch_system)

torch.set_num_threads(1)

LR = 1e-3  # large enough that a step moves every parameter visibly
TRAINABLE = ["temporal_graph"] + [CKPT_KEYS[t] for t in ACTIVE]


@pytest.mark.parametrize("layout", ["slice", "concat"])
def test_three_fused_adam_steps_match_jax(layout):
    jsys, params = jax_system(layout)
    init = to_np(params)
    tsys = torch_system(params, layout)
    jb, tb = batches(jsys)

    # gradients of step 1
    jgrads, _ = jax.jit(jax.grad(jsys._make_phase1_loss_fn(ACTIVE),
                                 has_aux=True))(params, jb,
                                                jax.random.PRNGKey(0))
    tparams = tsys.params()
    total, _ = tsys._make_phase1_loss_fn(ACTIVE)(tb, None)
    names = [n for n in tparams if interop.top_level_key(n) in TRAINABLE]
    tgrads = dict(zip(names, torch.autograd.grad(
        total, [tparams[n] for n in names])))
    for name, g in interop.from_flax(to_np(jgrads)).items():
        if name in tgrads:
            close(tgrads[name], g, err_msg=name, **MODULE_TOL)
        else:  # the frozen OSCC head is outside the loss graph
            assert name.startswith("task.oscc.") and not g.any()

    # three steps of impl="fused" on both sides
    jo = jopt.adam(LR, 1e-5, trainable_mask=j_mask(TRAINABLE), impl="fused")
    jstate = jo.init(params)
    jstep = jsys.make_train_step(jo, ACTIVE)
    to = topt.adam(LR, 1e-5, trainable_mask=topt.trainable_mask_fn(TRAINABLE),
                   impl="fused")
    tstate = to.init(tsys.params())
    tstep = tsys.make_train_step(to, ACTIVE)
    for k in range(3):
        params, jstate, jl = jstep(params, jstate, jb, jax.random.PRNGKey(k),
                                   LR)
        tl = tstep(tstate, tb, None, LR)
        assert set(tl) == set(jl)
        for key in jl:
            tol = LOSS_TOL if key.endswith("_loss") else MODULE_TOL
            close(tl[key], jl[key], err_msg=f"step {k} {key}", **tol)

    final = interop.from_flax(to_np(params))
    init_t = interop.from_flax(init)
    for name, p in tsys.params().items():
        close(p, final[name], err_msg=name, **MODULE_TOL)
        if name.startswith("task.oscc."):
            np.testing.assert_array_equal(p.detach().numpy(),
                                          init_t[name].numpy())
            np.testing.assert_array_equal(final[name].numpy(),
                                          init_t[name].numpy())
        else:
            assert not np.array_equal(p.detach().numpy(),
                                      init_t[name].numpy()), name


@pytest.mark.parametrize("name", ["ar", "oscc", "pnr", "lta"])
def test_graph_specs_match_jax(name):
    """The port's copy of ``data/graphs.py`` builds the same graphs; for LTA
    the per-sample forecast edges (strict ``y > 0`` count) agree three ways:
    both host versions and the port's batched ``lta_full_adjacency``."""
    make = {"ar": lambda g: g.ar_spec(9, 1.0), "oscc": lambda g: g.oscc_spec(1.0),
            "pnr": lambda g: g.pnr_spec(16, 1.0),
            "lta": lambda g: g.lta_spec(2, 20, 1.0)}[name]
    ours, ref = make(tgraphs), make(jgraphs)
    for field in ("name", "num_nodes", "lta_extra", "radius",
                  "num_input_clips"):
        assert getattr(ours, field) == getattr(ref, field), field
    np.testing.assert_array_equal(ours.pos, ref.pos)
    np.testing.assert_array_equal(ours.adjacency, ref.adjacency)
    if not ours.lta_extra:
        return
    rng = np.random.default_rng(7)
    y = np.full((4, ours.num_nodes, 2), -1, np.int64)
    y[:, 2:, 0] = rng.integers(0, 3, (4, ours.num_nodes - 2))  # verb 0 too
    y[3, 2:, 0] = 0  # no forecast target at all
    batched = lta_full_adjacency(torch.from_numpy(ours.adjacency),
                                 torch.from_numpy(y), ours.radius).numpy()
    for b in range(4):
        host = tgraphs.lta_extra_adjacency_host(ours, y[b, :, 0])
        np.testing.assert_array_equal(
            host, jgraphs.lta_extra_adjacency_host(ref, y[b, :, 0]))
        np.testing.assert_array_equal(batched[b], ours.adjacency | host)


def test_synthetic_batches_match_jax():
    """The port's entry draws the same batches from the same numpy seed."""
    jsys, params = jax_system()
    tsys = torch_system(params)
    jb = to_np(ge._synthetic_batches(jsys, BATCH, FEAT, seed=4))
    tb = synthetic_batches(tsys, BATCH, FEAT, seed=4)
    assert set(tb) == set(jb)
    for name in jb:
        assert set(tb[name]) == set(jb[name])
        for key, ref in jb[name].items():
            np.testing.assert_array_equal(tb[name][key].numpy(), ref,
                                          err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", ["ar", "lta", "pnr", "oscc"])
def test_backbone_features_per_task_match_jax(name):
    """The unfused path: compact-batch expansion, per-sample LTA edges and
    the plain ``reason`` stack."""
    jsys, params = jax_system()
    tsys = torch_system(params)
    jb, tb = batches(jsys, seed=3)
    jfeat, jmask = jsys.backbone_features(params, jb[name], name, train=False,
                                          rng=None)
    tfeat, tmask = tsys.backbone_features(tb[name], name, False, None)
    close(tfeat, jfeat, **MODULE_TOL)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_bf16_compute_losses_match_jax():
    """compute_dtype=bfloat16: bf16 operands into the first product, f32
    results after it, on both sides."""
    jsys, params = jax_system("concat")
    jsys.compute_dtype = jnp.bfloat16
    tsys = torch_system(params, "concat", compute_dtype=torch.bfloat16)
    jb, tb = batches(jsys)
    _, jlogs = jsys._make_phase1_loss_fn(ACTIVE)(params, jb,
                                                 jax.random.PRNGKey(0))
    _, tlogs = tsys._make_phase1_loss_fn(ACTIVE)(tb, None)
    for key in jlogs:
        close(tlogs[key], jlogs[key], err_msg=key, **MODULE_TOL)


def test_multi_step_matches_single_steps():
    """``entry.MTLStep`` over K groups is K plain calls of the one step;
    under "last" only the last logs the global norms."""
    _, params = jax_system()
    runs, logs = [], []
    for multi in (False, True):
        tsys = torch_system(params, "concat")
        groups = [synthetic_batches(tsys, BATCH, FEAT, seed=s)
                  for s in (1, 2)]
        groups = [{n: g[n] for n in ACTIVE} for g in groups]
        opt = topt.adam(LR, 1e-5, impl="fused",
                        trainable_mask=topt.trainable_mask_fn(TRAINABLE))
        state = opt.init(tsys.params())
        if multi:
            step = tsys.make_train_step(opt, ACTIVE, "last")
            logs.append(MTLStep(tsys, opt, state, step, groups, None,
                                "last")(LR))
            assert logs[-1]["ar_loss"].shape == (2,)
            assert logs[-1]["grad_norm"].shape == ()
        else:
            step = tsys.make_train_step(opt, ACTIVE)
            logs.append([step(state, g, None, LR) for g in groups])
        runs.append({n: p.detach().clone() for n, p in tsys.params().items()})
    for name in runs[0]:
        torch.testing.assert_close(runs[1][name], runs[0][name], rtol=0,
                                   atol=0)
    plain, grouped = logs
    for key in ("ar_loss", "lta_loss", "pnr_loss"):
        assert torch.equal(grouped[key], torch.stack([l[key] for l in plain]))
    assert torch.equal(grouped["grad_norm"], plain[-1]["grad_norm"])
