"""The port's phase-2 EgoPack step against the JAX one, same weights
(``interop``), same banks and batches, dropout off, for two novel tasks:
OSCC over the AR/LTA/PNR banks with the entry's narrow aux sets, and LTA
over the AR/OSCC/PNR banks with the published ones
(``experiments/egopack/lta.yaml``; there the backbone is frozen). Tolerances:
losses rtol 1e-5; gradients, norms, logits and parameters rtol 1e-4 /
atol 1e-5 (float32 sums in another order)."""

import jax
import numpy as np
import pytest
import torch

from egopack_torch import entry as tentry
from egopack_torch import interop
from egopack_torch.models.heads import OSCCTask as TOSCC
from egopack_torch.train import optim as topt
from egopack_torch.train.checkpoint import merge_loaded_params
from egopack_torch.train.system import CKPT_KEYS
from egopack_tpu.models.heads import OSCCTask as JOSCC
from egopack_tpu.train import checkpoint as jckpt
from egopack_tpu.train import optim as jopt
from egopack_tpu.train.driver import trainable_mask_fn as j_mask
from torch_port_common import (FEAT, HIDDEN, LOSS_TOL, MODULE_TOL,
                               PUBLISHED_AUX, batches, close, jax_phase2,
                               jax_system, numpy_banks, to_np, torch_phase2,
                               torch_system)

torch.set_num_threads(1)

LR = 1e-3
ACTIVE = ("oscc",)
# each novel task: the tasks whose banks GraphONE reads, and its heads' aux
# classifier sets (None: the entry's narrow ones)
NOVEL = {"oscc": (("ar", "lta", "pnr"), None),
         "lta": (("ar", "oscc", "pnr"), PUBLISHED_AUX)}


def _trainable(backprop=True, freeze=True, novel="oscc"):
    keys = [CKPT_KEYS[novel], "graphone"]
    if not freeze:
        keys.append("graphone_banks")
    if backprop:
        keys.append("temporal_graph")
    return keys


def _setup(freeze=True, k=8, novel="oscc"):
    tasks, head_aux = NOVEL[novel]
    banks = numpy_banks(tasks=tasks)
    jsys, jgo, params, jb = jax_phase2(banks, k=k, freeze=freeze,
                                       head_aux=head_aux)
    tsys, tgo, tb = torch_phase2(params, banks, k=k, freeze=freeze,
                                 head_aux=head_aux)
    jbatch, tbatch = batches(jsys, seed=2)
    return (jsys, jgo, params, jb, jbatch), (tsys, tgo, tb, tbatch)


@pytest.mark.parametrize("novel,backprop", [
    pytest.param("oscc", True, id="True"),
    pytest.param("oscc", False, id="False"),
    pytest.param("lta", False, id="lta-False")])
def test_loss_and_gradients_match_jax(novel, backprop):
    (jsys, jgo, params, jb, jbatch), (tsys, tgo, tb, tbatch) = _setup(
        novel=novel)
    active = (novel,)
    kw = dict(backprop_temporal_graph=backprop,
              temporal_graph_train_mode=False, late_fusion=True)
    jloss_fn = jsys.make_egopack_loss_fn(active, jgo, **kw)
    (jtotal, jlogs), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(params, jb, jbatch, jax.random.PRNGKey(0))
    tloss_fn = tsys.make_egopack_loss_fn(active, tgo, **kw)
    ttotal, tlogs = tloss_fn(tb, tbatch, None)
    close(ttotal, jtotal, **LOSS_TOL)
    close(tlogs[f"{novel}_loss"], jlogs[f"{novel}_loss"], **LOSS_TOL)
    tparams = tsys.params()
    names = [n for n in tparams
             if interop.top_level_key(n) in _trainable(backprop, novel=novel)]
    tgrads = dict(zip(names, torch.autograd.grad(
        ttotal, [tparams[n] for n in names], materialize_grads=True)))
    jflat = interop.from_flax(to_np(jgrads))
    assert set(jflat) == set(tparams)
    for name, g in jflat.items():
        if name in tgrads:
            close(tgrads[name], g, err_msg=name, **MODULE_TOL)
        else:  # outside the loss graph: the aux heads' own projections
            assert not g.any(), name
    moved = [n for n in names if tgrads[n].abs().sum() > 0]
    assert any(n.startswith("graphone.") for n in moved)
    # each bank's task reaches the novel head through its aux classifier
    for t in NOVEL[novel][0]:
        assert any(n.startswith(f"task.{novel}.aux_{t}_cls") for n in moved)
    assert any(n.startswith("temporal_graph.") for n in moved) == backprop


@pytest.mark.parametrize("novel,backprop,freeze", [
    pytest.param("oscc", True, True, id="True-True"),
    pytest.param("oscc", False, True, id="False-True"),
    pytest.param("oscc", True, False, id="True-False"),
    pytest.param("lta", False, True, id="lta-False-True")])
def test_three_steps_match_jax(novel, backprop, freeze):
    (jsys, jgo, params, jb, jbatch), (tsys, tgo, tb, tbatch) = _setup(
        freeze, novel=novel)
    active = (novel,)
    init = interop.from_flax(to_np(params))
    kw = dict(backprop_temporal_graph=backprop,
              temporal_graph_train_mode=False, late_fusion=True)
    trainable = _trainable(backprop, freeze, novel)
    jo = jopt.adam(LR, 1e-5, trainable_mask=j_mask(trainable), impl="fused")
    jstate = jo.init(params)
    jstep = jsys.make_egopack_train_step(jo, active, jgo, **kw)
    to = topt.adam(LR, 1e-5, trainable_mask=topt.trainable_mask_fn(trainable),
                   impl="fused")
    tstate = to.init(tsys.params())
    tstep = tsys.make_egopack_train_step(to, active, tgo, **kw)
    for k in range(3):
        params, jstate, jl = jstep(params, jstate, jb, jbatch,
                                   jax.random.PRNGKey(k), LR)
        tl = tstep(tstate, tb, tbatch, None, LR)
        assert set(tl) == set(jl)
        for key in jl:
            tol = LOSS_TOL if key.endswith("_loss") else MODULE_TOL
            close(tl[key], jl[key], err_msg=f"step {k} {key}", **tol)
    final = interop.from_flax(to_np(params))
    for name, p in tsys.params().items():
        close(p, final[name], err_msg=name, **MODULE_TOL)
        if interop.top_level_key(name) in trainable:
            assert not torch.equal(p.detach(), init[name]), name
        else:  # the backbone and the other heads, aux classifiers too
            assert torch.equal(p.detach(), init[name]), name
    for t in tb:  # the banks passed in never change
        np.testing.assert_array_equal(tb[t].values.numpy(),
                                      np.asarray(jb[t].values))


def test_eval_mode_backbone_ignores_the_dropout_generator():
    """``temporal_graph_train_mode=False`` (novel LTA's published setting):
    with the pooling's dropout at 0.5, two generators give the same
    backbone features in eval mode, and other ones in train mode."""
    system = tentry.build_system(HIDDEN, HIDDEN, FEAT, tp_dropout=0.5,
                                 phase2=True, device="cpu")
    system.init_params(torch.Generator().manual_seed(0))
    _, batch = batches(jax_system()[0], seed=2)

    def features(train, seed):
        with torch.no_grad():
            return system.backbone_features(
                batch["lta"], "lta", train,
                torch.Generator().manual_seed(seed))[0]

    assert torch.equal(features(False, 1), features(False, 2))
    assert not torch.equal(features(True, 1), features(True, 2))


def test_multi_step_matches_single_steps():
    """``entry.EgoPackStep`` over K groups is K plain calls of the one step;
    under "last" only the last logs the global norms."""
    banks = numpy_banks()
    _, _, params, _ = jax_phase2(banks)
    runs, logs = [], []
    for multi in (False, True):
        tsys, tgo, tb = torch_phase2(params, banks)
        jsys, _ = jax_system()
        groups = [batches(jsys, seed=s)[1] for s in (1, 2)]
        opt = topt.adam(LR, 1e-5, impl="fused",
                        trainable_mask=topt.trainable_mask_fn(_trainable()))
        state = opt.init(tsys.params())
        if multi:
            step = tsys.make_egopack_train_step(opt, ACTIVE, tgo,
                                                log_norms="last")
            logs.append(tentry.EgoPackStep(tsys, tgo, tb, opt, state, step,
                                           groups, None, "last")(LR))
            assert logs[-1]["oscc_loss"].shape == (2,)
            assert logs[-1]["grad_norm"].shape == ()
        else:
            step = tsys.make_egopack_train_step(opt, ACTIVE, tgo)
            logs.append([step(state, tb, g, None, LR) for g in groups])
        runs.append({n: p.detach().clone() for n, p in tsys.params().items()})
    for name in runs[0]:
        torch.testing.assert_close(runs[1][name], runs[0][name], rtol=0,
                                   atol=0)
    plain, grouped = logs
    assert torch.equal(grouped["oscc_loss"],
                       torch.stack([l["oscc_loss"] for l in plain]))
    assert torch.equal(grouped["grad_norm"], plain[-1]["grad_norm"])


@pytest.mark.parametrize("name,late", [("oscc", True), ("oscc", False),
                                       ("pnr", True), ("ar", False)])
def test_eval_step_matches_jax(name, late):
    (jsys, jgo, params, jb, jbatch), (tsys, tgo, tb, tbatch) = _setup()
    aux = tuple(a for a in ("ar", "lta", "pnr") if a != name)
    jstep = jsys.make_eval_step(name, aux=aux, graphone=jgo, late_fusion=late)
    tstep = tsys.make_eval_step(name, aux=aux, graphone=tgo, late_fusion=late)
    jout = jstep(params, jbatch[name], jb)
    tout = tstep(tbatch[name], tb)
    jlogits, tlogits = jout[0], tout[0]
    if isinstance(jlogits, tuple):
        assert len(jlogits) == len(tlogits) == 2
        for a, b in zip(tlogits, jlogits):
            close(a, b, **MODULE_TOL)
    else:
        close(tlogits, jlogits, **MODULE_TOL)
    for a, b in zip(tout[1:3], jout[1:3]):
        assert tuple(a.shape) == b.shape
        close(a, b, **MODULE_TOL)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert tout[2].shape[-1] == HIDDEN * (1 + len(aux))


def test_phase1_eval_step_matches_jax():
    jsys, params = jax_system()
    tsys = torch_system(params)
    jbatch, tbatch = batches(jsys, seed=6)
    jout = jsys.make_eval_step("oscc")(params, jbatch["oscc"], None)
    tout = tsys.make_eval_step("oscc")(tbatch["oscc"])
    for a, b in zip(tout[:3], jout[:3]):
        close(a, b, **MODULE_TOL)


@pytest.mark.parametrize("loss_func", ["ce", "bce", "focal"])
def test_oscc_compute_loss_matches_jax(loss_func):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(7, 2)).astype(np.float32) * 3
    y = rng.integers(0, 2, size=7).astype(np.int32)
    y[2] = -1
    jhead = JOSCC(name_="oscc", input_size=8, features_size=8,
                  loss_func=loss_func)
    ref = jhead.compute_loss(logits, y)
    ours = TOSCC("oscc", 8, 8, loss_func=loss_func,
                 device="cpu").compute_loss(torch.from_numpy(logits),
                                            torch.from_numpy(y))
    close(ours, ref, **LOSS_TOL)
    if loss_func == "ce":
        assert float(ours[2]) == 0.0


def test_merge_loaded_params_matches_jax():
    """strict=False: the phase-1 state fills every leaf it names; the aux
    classifiers and GraphONE keep their fresh values."""
    _, p1 = jax_system()
    _, _, p2, _ = jax_phase2(numpy_banks())
    p1 = jax.tree_util.tree_map(lambda a: a + 1.0, p1)
    ref = interop.from_flax(to_np(jckpt.merge_loaded_params(p2, p1)))
    fresh, loaded = interop.from_flax(to_np(p2)), interop.from_flax(to_np(p1))
    loaded["task.oscc.not_in_phase2"] = torch.zeros(3)
    merged = merge_loaded_params(fresh, loaded)
    assert set(merged) == set(ref) == set(fresh)
    for name, value in merged.items():
        torch.testing.assert_close(value, ref[name], rtol=0, atol=0)
        src = loaded if name in loaded else fresh
        assert value is src[name]
    assert any(n.startswith("task.oscc.aux_") for n in merged)
    assert not any(n.startswith(("graphone", "task.oscc.aux_"))
                   for n in loaded)
