"""The port's meters and validation loops against the JAX package's: the
meters fed the same arrays give the same logs; ``validate``,
``validate_pnr`` and ``validate_lta`` from the same weights on the same
fixture give JAX's meters (accuracies, recalls and localization error
exactly; losses, calibration and AUROC at rtol 1e-4); the LTA sampler's
frequencies match the softmax (within 4 sigma over 20,000 draws)."""

import jax
import numpy as np
import pytest
import torch

from egopack_torch import interop
from egopack_torch.config import compose as tcompose
from egopack_torch.config import default_config_dir
from egopack_torch.eval import meters as tmeters
from egopack_torch.eval import validate as tval
from egopack_torch.models.heads import LTATask
from egopack_torch.train import driver as tdriver
from egopack_tpu.config import compose as jcompose
from egopack_tpu.eval import meters as jmeters
from egopack_tpu.eval import validate as jval
from egopack_tpu.train import driver as jdriver
from torch_port_common import to_np

torch.set_num_threads(1)

EXACT = ("top", "accuracy", "recall", "_mc", "localization_error")


def overrides(root):
    return ["seed=1", "k=1", "batch_size=4", "num_workers=0",
            "model.hidden_size=16", "model.temporal_pooling.hidden_size=16",
            "model.temporal_pooling.dropout=0", "model.depth=2",
            "oscc_feat_size=16", "validation_split=val",
            f"dataset_recognition.root={root}", f"dataset_oscc.root={root}",
            f"dataset_lta.root={root}", f"dataset_pnr.root={root}",
            "parallel.data=1", "parallel.model=1", "device=cpu"]


def assert_logs_match(ours, ref, what):
    assert set(ours) == set(ref), what
    for k, v in ref.items():
        if any(tag in k for tag in EXACT) and "calibration" not in k \
                and not k.endswith("_ed"):
            assert ours[k] == v, (what, k, ours[k], v)
        else:
            np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def systems(ego4d_root):
    """The JAX and the port's phase-1 systems built by their drivers from
    the same config, carrying the same weights, with their datasets."""
    jcfg = jcompose(default_config_dir(), "defaults", overrides(ego4d_root))
    jd = jdriver.build_datasets(jcfg)
    jsys = jdriver.build_system(jcfg, jd)
    params = jsys.init_params(jax.random.PRNGKey(0),
                              jd["ar"]["train"].features_size)
    tcfg = tcompose(default_config_dir(), "defaults", overrides(ego4d_root))
    td = tdriver.build_datasets(tcfg)
    tsys = tdriver.build_system(tcfg, td, torch.device("cpu"))
    tsys.load_state(interop.from_flax(to_np(params)))
    return jsys, params, jd, tsys, td


@pytest.mark.parametrize("task", ["ar", "oscc", "pnr", "lta"])
def test_validation_matches_jax(systems, task):
    jsys, params, jd, tsys, td = systems
    jm = jmeters.build_meter_for_dataset(jd[task]["val"])
    tm = tmeters.build_meter_for_dataset(td[task]["val"])
    assert type(tm).__name__ == type(jm).__name__
    jstep, tstep = jsys.make_eval_step(task), tsys.make_eval_step(task)
    cpu = torch.device("cpu")
    if task == "pnr":
        jval.validate_pnr(jstep, params, None, jd[task]["dl_val"], jm)
        tval.validate_pnr(tstep, None, td[task]["dl_val"], tm, cpu)
    elif task == "lta":
        head = jsys.tasks["lta"].head
        jval.validate_lta(jstep, params, None, jd[task]["dl_val"], jm,
                          jax.jit(head.generate_from_logits),
                          jax.random.PRNGKey(3))
        tval.validate_lta(tstep, None, td[task]["dl_val"], tm,
                          LTATask.generate_from_logits,
                          torch.Generator().manual_seed(3), cpu)
    else:
        jval.validate(jstep, params, None, jd[task]["dl_val"], jm, task)
        tval.validate(tstep, None, td[task]["dl_val"], tm, task, cpu)
    ours, ref = tm.get_logs(), jm.get_logs()
    if task == "lta":
        # samples differ (JAX keys against a torch generator): the loss
        # and the node top-1 agree, the edit distances lie in range
        for k in ("loss", "verbs_top1", "nouns_top1"):
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)
        assert 0.0 <= ours["verbs_ed"] <= 1.0 and 0.0 <= ours["nouns_ed"] <= 1
        return
    assert_logs_match(ours, ref, task)


def meter_inputs(rng, n_verbs, n_nouns):
    v = rng.normal(size=(40, n_verbs)).astype(np.float32)
    n = rng.normal(size=(40, n_nouns)).astype(np.float32)
    labels = np.stack([rng.integers(-1, n_verbs, 40),
                       rng.integers(-1, n_nouns, 40)], 1)
    return v, n, labels


@pytest.mark.parametrize("task", ["ar", "oscc", "pnr", "lta"])
def test_meters_fed_the_same_arrays_match(systems, task):
    _, _, jd, _, td = systems
    rng = np.random.default_rng(4)
    jm = jmeters.build_meter_for_dataset(jd[task]["val"], log_confusion=True)
    tm = tmeters.build_meter_for_dataset(td[task]["val"], log_confusion=True)
    nv, nn = td["ar"]["val"].num_class_labels
    for step in range(3):
        if task == "ar":
            v, n, labels = meter_inputs(rng, nv, nn)
            args = ((v, n), labels, float(rng.random()))
        elif task == "oscc":
            args = (rng.normal(size=(8, 2)).astype(np.float32),
                    rng.integers(0, 2, 8), float(rng.random()))
        elif task == "pnr":
            logits = rng.normal(size=(4, 16)).astype(np.float32)
            labels = np.eye(16, dtype=np.int32)[rng.integers(0, 16, 4)]
            kw = dict(start_frame=rng.uniform(0, 100, 4).astype(np.float32),
                      end_frame=rng.uniform(200, 300, 4).astype(np.float32),
                      pnr_frame=rng.uniform(100, 200, 4).astype(np.float32))
            jm.update(logits, labels, 0.5 + step, **kw)
            tm.update(logits, labels, 0.5 + step, **kw)
            continue
        else:
            v = rng.normal(size=(2 * 22, nv)).astype(np.float32)
            n = rng.normal(size=(2 * 22, nn)).astype(np.float32)
            labels = np.full((2 * 22, 2), -1)
            labels[np.arange(44) % 22 >= 2] = np.stack(
                [rng.integers(0, nv, 40), rng.integers(0, nn, 40)], 1)
            preds = (rng.integers(0, nv, (44, 5)), rng.integers(0, nn, (44, 5)))
            args = ((v, n), labels, preds, float(rng.random()))
        jm.update(*args)
        tm.update(*args)
    assert tm.get_logs() == jm.get_logs()
    assert tm.print_logs() == jm.print_logs()
    if task == "ar":
        for which in ("verbs", "nouns"):
            assert tm.confusion_tables(which) == jm.confusion_tables(which)
            np.testing.assert_array_equal(tm.confusion(which),
                                          jm.confusion(which))


def test_feature_plots_raise_naming_roadmap(systems):
    tm = tmeters.build_meter_for_dataset(systems[4]["ar"]["val"],
                                         save_features=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.feature_embedding()


def test_generate_from_logits_matches_the_softmax():
    rng = np.random.default_rng(0)
    logits = (torch.from_numpy(rng.normal(size=(2, 3, 6)).astype(np.float32)),
              torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32)))
    gen = torch.Generator().manual_seed(0)
    preds, out = LTATask.generate_from_logits(logits, gen)
    assert [tuple(p.shape) for p in preds] == [(2, 3, 5), (2, 3, 5)]
    assert out[0] is logits[0] and out[1] is logits[1]
    draws = 20000
    preds, _ = LTATask.generate_from_logits(logits, gen, K=draws)
    for head, p in zip(logits, preds):
        probs = torch.softmax(head, -1).numpy()
        c = head.shape[-1]
        counts = np.stack([(p.numpy() == k).sum(-1) for k in range(c)], -1)
        freq = counts / draws
        sigma = np.sqrt(probs * (1 - probs) / draws)
        assert np.all(np.abs(freq - probs) <= 4 * sigma + 1e-12), \
            np.abs(freq - probs) / sigma
        assert p.min() >= 0 and p.max() < c
