"""The phase-2 slice as a whole: the port's EgoPack CLI against the JAX
package's ``main_egopack`` on the same fixture, from the same phase-1
artifact (made by JAX's ``main_temporal``) and the same initial phase-2
parameters (JAX's, after the merge and the GraphONE init, carried in by
``interop.from_flax``), dropout off.

Per-epoch train losses and norms agree at rtol 1e-4; validation of every
task (``validate_all_tasks``): accuracies exactly, losses rtol 1e-4, LTA
edit distances (other samples) in range; the banks' valid counts equal and
their values within rtol 1e-4 / atol 1e-5; the artifact has JAX's name and
meta, and JAX's ``load_artifact`` reads it to leaves within rtol 1e-4 /
atol 1e-5 of JAX's own, the bank masks equal. ``freeze=False`` trains the
banks into the artifact. A run resumed from an epoch-1 checkpoint equals
the straight run bit for bit. ``egopack_torch.evaluate`` matches
``egopack_tpu.evaluate`` on JAX's artifacts of both phases and reproduces
the port's own last validation exactly. The CLIs run as
``python -m egopack_torch.main_egopack`` and ``python -m
egopack_torch.evaluate`` with the verify notes' phase-2 command.
``log_per_layer_norms``, ``log_histograms_every`` and
``+model.propagate_dtype=bfloat16`` each run against ``main_egopack``,
with the tolerances of the phase-1 file."""

import json
import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import main_egopack as jmain_egopack
import main_temporal as jmain_temporal
from egopack_torch import evaluate as tevaluate
from egopack_torch import interop
from egopack_torch import main_egopack as tmain
from egopack_torch import main_temporal as tmain_temporal
from egopack_torch.data.synthetic import generate_ego4d_fixture
from egopack_torch.entry import build_mtl_step
from egopack_torch.train import checkpoint as tckpt
from egopack_torch.train import optim as toptim
from egopack_torch.train import system as tsystem
from egopack_tpu import evaluate as jevaluate
from egopack_tpu.train import checkpoint as jckpt
from egopack_tpu.train import optim as joptim
from torch_port_common import (BF16_UNIT, assert_histogram_files_match,
                               assert_train_records_match, by_epoch, records,
                               to_np)

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
MTL = "MTL_ar-lta-pnr"
NOVEL = "MTL_oscc"
GRAPHONE = ["graphone.k=2", "graphone.depth=1", "graphone.hidden_size=32",
            "graphone.residual=True"]


def base(root, tmp, *extra):
    """The phase-1 test's widths, dropout off, on the run's own
    directories."""
    return ["seed=1", "k=1", "batch_size=4", "num_workers=0",
            "model.hidden_size=32", "model.temporal_pooling.hidden_size=32",
            "oscc_feat_size=32", "model.temporal_pooling.dropout=0",
            "model.depth=2", f"dataset_recognition.root={root}",
            f"dataset_oscc.root={root}", f"dataset_lta.root={root}",
            f"dataset_pnr.root={root}", "validation_split=val",
            f"artifact_dir={tmp}/artifacts", f"output_dir={tmp}/outputs",
            "parallel.data=1", "parallel.model=1", *extra]


def phase2(root, tmp, *extra):
    """Novel OSCC from the phase-1 artifact: 2 epochs of steps_per_call=2
    groups, every task validated."""
    return base(root, tmp, "enable_graphone=True", "enabled_tasks=[oscc]",
                f"resume_from={MTL}", *GRAPHONE, "num_epochs=2",
                "optimizer.lr=1e-6", "steps_per_call=2",
                "validate_all_tasks=True", "save_model=True", *extra)


def flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(value)


def assert_metrics_match(ours, ref, what):
    """Accuracies and counts exactly, losses and calibration rtol 1e-4,
    LTA edit distances (sampled) in range."""
    assert set(ours) == set(ref), what
    for k, v in ref.items():
        if not isinstance(v, (int, float)):
            continue
        if "lta" in what and k.endswith("_ed"):
            assert 0.0 <= ours[k] <= 1.0, (what, k)
        elif k.endswith(("loss", "calibration_error", "brier_score",
                         "auroc")):
            np.testing.assert_allclose(ours[k], v, rtol=1e-4,
                                       err_msg=f"{what} {k}")
        else:
            assert ours[k] == v, (what, k)


def share_jax_init(mp, init):
    """Record JAX's initial phase-2 parameters (after the merge and the
    GraphONE init) and start the port's optimizer from them."""
    orig_state = joptim.init_opt_state

    def capture(optimizer, params, mesh):
        init["params"] = to_np(params)
        return orig_state(optimizer, params, mesh)

    orig_init = toptim.Adam.init

    def jax_init(self, params):
        state = interop.from_flax(init["params"])
        assert set(state) == set(params)
        with torch.no_grad():
            for n, v in state.items():
                params[n].copy_(v)
        return orig_init(self, params)

    mp.setattr(joptim, "init_opt_state", capture)
    mp.setattr(toptim.Adam, "init", jax_init)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ego4d"))
    generate_ego4d_fixture(root, feature_dim=16, seed=2)
    mtl = str(tmp_path_factory.mktemp("mtl"))
    jmain_temporal.main(base(root, mtl, "num_epochs=1", "save_model=True",
                             "enabled_tasks=[ar,lta,pnr]"))
    tmp = {}
    for k in ("jax", "port", "jax_tb", "port_tb", "straight", "resumed"):
        tmp[k] = str(tmp_path_factory.mktemp(k))
        shutil.copytree(f"{mtl}/artifacts/{MTL}", f"{tmp[k]}/artifacts/{MTL}")
    mp = pytest.MonkeyPatch()
    init = {}
    out = dict(root=root, tmp=tmp)
    try:
        share_jax_init(mp, init)
        for sfx, extra in (("", ()), ("_tb", ("graphone.freeze=False",
                                             "optimizer.lr=1e-2",
                                             "artifact_prefix=TB"))):
            out["jres" + sfx] = jmain_egopack.main(
                phase2(root, tmp["jax" + sfx], *extra))
            out["tres" + sfx] = tmain.main(
                phase2(root, tmp["port" + sfx], *extra, "device=cpu"))
        mp.undo()
        # the resume check runs with dropout on, so that the restored
        # generator state matters
        drop = ("device=cpu", "task_head_dropout=0.5",
                "temporal_graph_train_mode=True",
                "model.temporal_pooling.dropout=0.5",
                f"checkpoint.dir={tmp['resumed']}/ckpt")
        out["straight"] = tmain.main(phase2(root, tmp["straight"], *drop))
        out["first"] = tmain.main(phase2(root, tmp["resumed"], *drop,
                                         "num_epochs=1",
                                         "checkpoint.enable=True"))
        out["resumed"] = tmain.main(phase2(root, tmp["resumed"], *drop,
                                           "checkpoint.enable=True"))
    finally:
        mp.undo()
    return out


def test_train_losses_and_norms_match_jax(runs):
    ours = by_epoch(records(runs["tres"]["run_dir"]), "train/")
    ref = by_epoch(records(runs["jres"]["run_dir"]), "train/")
    assert sorted(ours) == sorted(ref) == [1, 2]
    for epoch in ref:
        assert set(ours[epoch]) == set(ref[epoch]) >= {"train/oscc/loss"}
        for k, v in ref[epoch].items():
            np.testing.assert_allclose(ours[epoch][k], v, rtol=1e-4,
                                       err_msg=f"epoch {epoch} {k}")


def test_validation_metrics_match_jax(runs):
    ours = runs["tres"]["val_metrics"]
    ref = runs["jres"]["val_metrics"]
    assert sorted(ours) == sorted(ref) == ["ar", "lta", "oscc", "pnr"]
    for task in ref:
        assert_metrics_match(ours[task], ref[task], task)
    recs = by_epoch(records(runs["tres"]["run_dir"]), "val/")
    assert sorted(recs) == [1, 2]  # phase 2 validates every epoch


def test_banks_match_jax(runs):
    ours, ref = runs["tres"]["banks"], runs["jres"]["banks"]
    assert sorted(ours) == sorted(ref) == ["ar", "lta", "pnr"]
    for t in ref:
        assert ours[t].num_valid == ref[t].num_valid > 2
        np.testing.assert_array_equal(ours[t].mask.numpy(),
                                      np.asarray(ref[t].mask))
        np.testing.assert_allclose(ours[t].values.numpy(),
                                   np.asarray(ref[t].values), **TOL,
                                   err_msg=t)


@pytest.mark.parametrize("prefix,sfx", [("MTL", ""), ("TB", "_tb")])
def test_artifact_matches_jax(runs, prefix, sfx):
    tmp = runs["tmp"]
    name = f"{prefix}_oscc"
    assert runs["tres" + sfx]["artifact"] == runs["jres" + sfx]["artifact"] \
        == name
    ours, ours_meta = jckpt.load_artifact(f"{tmp['port' + sfx]}/artifacts",
                                          name)
    ref, ref_meta = jckpt.load_artifact(f"{tmp['jax' + sfx]}/artifacts", name)
    assert ours_meta == ref_meta
    assert ours_meta["phase"] == "egopack"
    assert ours_meta["aux_tasks"] == ["ar", "lta", "pnr"]
    assert int(ours.pop("epoch")) == 2
    ours, ref = dict(flat(ours)), dict(flat(ref))
    assert set(ours) == set(ref)
    assert {k.split("/")[0] for k in ref} >= {"graphone", "graphone_banks",
                                             "graphone_bank_masks"}
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype, k
        if k.startswith("graphone_bank_masks"):
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(ours[k], v, **TOL, err_msg=k)


def test_trainable_banks_land_in_the_artifact(runs):
    res = runs["tres_tb"]
    params = res["system"].params()
    assert "graphone_banks.ar" in params
    moved = [t for t, b in res["banks"].items()
             if not torch.equal(params[f"graphone_banks.{t}"].detach(),
                                b.values)]
    assert moved == ["ar", "lta", "pnr"]
    payload, meta = tckpt.load_artifact(f"{runs['tmp']['port_tb']}/artifacts",
                                        "TB_oscc")
    assert meta["graphone"]["freeze"] is False
    for t in moved:
        np.testing.assert_array_equal(
            payload["graphone_banks"][t],
            params[f"graphone_banks.{t}"].detach().numpy())


def test_resumed_run_equals_straight_run(runs):
    assert runs["first"]["start_epoch"] == 1
    assert runs["resumed"]["start_epoch"] == 2
    assert [s["epoch"] for s in runs["resumed"]["epochs"]] == [2]
    ckpt = osp.join(runs["tmp"]["resumed"], "ckpt", f"egopack_{NOVEL}")
    assert tckpt.latest_state(ckpt) == 2
    a = runs["straight"]["system"].params()
    b = runs["resumed"]["system"].params()
    assert {n.split(".")[0] for n in a} >= {"graphone"}
    for name in a:
        assert torch.equal(a[name], b[name]), name
    sa, sb = runs["straight"]["opt_state"], runs["resumed"]["opt_state"]
    assert sa.count == sb.count == 12
    for name in sa.mu:
        assert torch.equal(sa.mu[name], sb.mu[name]), name
        assert torch.equal(sa.nu[name], sb.nu[name]), name
    la = by_epoch(records(runs["straight"]["run_dir"]), "train/")[2]
    lb = by_epoch(records(runs["resumed"]["run_dir"]), "train/")[2]
    assert la == lb


def test_errors(runs):
    root, tmp = runs["root"], runs["tmp"]["port"]
    with pytest.raises(SystemExit, match="Invalid configuration"):
        tmain.main(phase2(root, tmp, "device=cpu", "enable_graphone=False"))
    with pytest.raises(ValueError, match="resume_from"):
        tmain.main(phase2(root, tmp, "device=cpu", "resume_from=null"))


@pytest.mark.parametrize("extra,match", [
    ("parallel.data=2", "number of processes"),
    ("parallel.multihost=True", "env://"),
])
def test_unsupported_settings_raise(runs, extra, match, monkeypatch):
    """A grid larger than the world of processes raises, and so does a
    multi-process run without its rendezvous."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=match):
        tmain.main(phase2(runs["root"], runs["tmp"]["port"], "device=cpu",
                          "num_epochs=1", "save_model=False", extra))


@pytest.mark.parametrize("extra", ["loader_processes=2",
                                   "log_feature_plots=True"])
def test_loader_and_plot_settings_train_as_the_plain_run(runs, tmp_path,
                                                         extra):
    """Worker processes and t-SNE plots leave the trajectory as it was:
    one epoch equals the resume check's first epoch (dropout on, loaders in
    this process, no plots) bit for bit, its validation too. The plots
    are ``features_<task>_ep1.npz`` with two coordinates a sample."""
    shutil.copytree(f"{runs['tmp']['port']}/artifacts/{MTL}",
                    f"{tmp_path}/artifacts/{MTL}")
    ours = tmain.main(phase2(runs["root"], str(tmp_path), "device=cpu",
                             "task_head_dropout=0.5",
                             "temporal_graph_train_mode=True",
                             "model.temporal_pooling.dropout=0.5",
                             "num_epochs=1", "save_model=False", extra))
    ref = runs["first"]
    pa, pb = ours["system"].params(), ref["system"].params()
    for name in pb:
        assert torch.equal(pa[name], pb[name]), name
    for prefix in ("train/", "val/"):
        assert by_epoch(records(ours["run_dir"]), prefix) == by_epoch(
            records(ref["run_dir"]), prefix)
    if extra.startswith("log_feature_plots"):
        for task in ("ar", "oscc", "lta", "pnr"):
            with np.load(osp.join(ours["run_dir"],
                                  f"features_{task}_ep1.npz")) as npz:
                assert sorted(npz.files) == ["post", "pre"]
                for which in npz.files:
                    assert npz[which].ndim == 2 and len(npz[which]) > 0
                    assert npz[which].shape[1] == 2


def test_pooling_encoding_runs_in_phase2(runs, tmp_path):
    """``model.temporal_pooling.encoding=positional`` in phase 2: the
    phase-1 artifact has no ``encoding_mlp``, which keeps its fresh values
    (strict=False merge) and lands in the phase-2 artifact."""
    shutil.copytree(f"{runs['tmp']['port']}/artifacts/{MTL}",
                    f"{tmp_path}/artifacts/{MTL}")
    ours = tmain.main(phase2(runs["root"], str(tmp_path), "device=cpu",
                             "num_epochs=1",
                             "model.temporal_pooling.encoding=positional"))
    for rec in records(ours["run_dir"]):
        for k, v in rec.items():
            if k.startswith("train/"):
                assert np.isfinite(v), k
    payload, _ = jckpt.load_artifact(f"{tmp_path}/artifacts", NOVEL)
    mlp = payload["temporal_graph"]["pooling"]["encoding_mlp"]
    assert mlp["kernel"].shape == (16, 16) and mlp["bias"].shape == (16,)


@pytest.mark.parametrize("phase", ["mtl", "egopack"])
def test_a_run_builds_one_train_step(runs, tmp_path, monkeypatch, phase):
    """A driver run with ``steps_per_call`` above 1 (phase 1: the config's
    4; phase 2: 2) builds its train step once: one call of
    ``MultiTaskSystem._make_inner_step``, so one table of CUDA graphs."""
    calls = []
    orig = tsystem.MultiTaskSystem._make_inner_step

    def counted(self, *args, **kw):
        calls.append(args)
        return orig(self, *args, **kw)

    monkeypatch.setattr(tsystem.MultiTaskSystem, "_make_inner_step", counted)
    if phase == "mtl":
        tmain_temporal.main(base(runs["root"], str(tmp_path), "device=cpu",
                                 "num_epochs=1", "save_model=False",
                                 "enabled_tasks=[ar,lta,pnr]"))
    else:
        shutil.copytree(f"{runs['tmp']['port']}/artifacts/{MTL}",
                        f"{tmp_path}/artifacts/{MTL}")
        tmain.main(phase2(runs["root"], str(tmp_path), "device=cpu",
                          "num_epochs=1", "save_model=False"))
    assert len(calls) == 1


@pytest.mark.parametrize("extra", ["log_per_layer_norms=True",
                                   "log_histograms_every=1",
                                   "+model.propagate_dtype=bfloat16"])
def test_step_options_match_jax(runs, tmp_path_factory, extra):
    """The option in both CLIs, two epochs from the phase-1 artifact and
    JAX's initial phase-2 parameters."""
    tmp = {}
    for k in ("jax", "port"):
        tmp[k] = str(tmp_path_factory.mktemp(k))
        shutil.copytree(f"{runs['tmp']['jax']}/artifacts/{MTL}",
                        f"{tmp[k]}/artifacts/{MTL}")
    mp = pytest.MonkeyPatch()
    try:
        share_jax_init(mp, {})
        jres = jmain_egopack.main(phase2(runs["root"], tmp["jax"], extra,
                                         "save_model=False"))
        tres = tmain.main(phase2(runs["root"], tmp["port"], extra,
                                 "save_model=False", "device=cpu"))
    finally:
        mp.undo()
    bf16 = "propagate_dtype" in extra
    ref = assert_train_records_match(tres, jres, BF16_UNIT if bf16 else 1e-4)
    if extra.startswith("log_per_layer_norms"):
        assert "train/grad_norm/graphone" in ref[1]
        assert ref[1]["train/grad_norm/task/recognition/proj_fc0"] == 0.0
    elif extra.startswith("log_histograms"):
        assert_histogram_files_match(tres["run_dir"], jres["run_dir"], (1, 2))
    else:
        assert tres["system"].backbone.propagate_dtype == torch.bfloat16


@pytest.mark.parametrize("cli", ["main_egopack", "evaluate"])
@pytest.mark.parametrize("device", ["tpu", "gpu", "cuda"])
def test_card_devices_raise_without_a_card(runs, monkeypatch, cli, device):
    """The configs' device=tpu means the card; without one both CLIs raise
    and never drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = tmain.main if cli == "main_egopack" else tevaluate.main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(phase2(runs["root"], runs["tmp"]["port"], f"device={device}"))


@pytest.mark.parametrize("artifact,which", [(NOVEL, "jax"), (MTL, "jax"),
                                            (NOVEL, "port")])
def test_evaluate_matches_jax(runs, artifact, which):
    """Both packages' cold evaluation of one artifact; every task of a
    phase-2 artifact (validate_all_tasks), the tasks of a phase-1 one."""
    adir = f"{runs['tmp'][which]}/artifacts"
    extra = [f"resume_from={artifact}", f"artifact_dir={adir}"]
    if artifact == NOVEL:
        extra.append("validate_all_tasks=True")
    ours = tevaluate.main(base(runs["root"], runs["tmp"]["port"], *extra,
                               "device=cpu"))
    ref = jevaluate.main(base(runs["root"], runs["tmp"]["jax"], *extra))
    tasks = ["ar", "lta", "oscc", "pnr"] if artifact == NOVEL \
        else ["ar", "lta", "pnr"]
    assert sorted(ours) == sorted(ref) == tasks
    for task in ref:
        assert_metrics_match(ours[task], ref[task], f"{artifact} {task}")


def test_evaluate_reproduces_the_drivers_last_validation(runs, tmp_path):
    """The port's phase-2 artifact, evaluated cold, gives the driver's last
    validation exactly (the LTA edit distances come from other samples)."""
    out = tmp_path / "metrics.json"
    adir = f"{runs['tmp']['port']}/artifacts"
    cold = tevaluate.main(base(runs["root"], str(tmp_path),
                               f"resume_from={NOVEL}", f"artifact_dir={adir}",
                               "validate_all_tasks=True", f"output={out}",
                               "device=cpu"))
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(cold))
    last = runs["tres"]["val_metrics"]
    assert sorted(cold) == sorted(last)
    for task, logs in last.items():
        for k, v in logs.items():
            if not (task == "lta" and k.endswith("_ed")):
                assert cold[task][k] == v, (task, k)


def test_fused_layout_env_reaches_the_entry(monkeypatch):
    """EGOPACK_FUSED_LAYOUT is read where no layout is given, as JAX's
    ``MultiTaskSystem`` reads it: ``slice`` at batch 2, where ``auto``
    picks ``concat``."""
    calls = []

    def spy(name):
        orig = getattr(type(system.backbone), name)

        def wrapped(self, *a, **kw):
            calls.append(name)
            return orig(self, *a, **kw)
        return wrapped

    monkeypatch.setenv("EGOPACK_FUSED_LAYOUT", "slice")
    mtl = build_mtl_step(2, 16, 32, tp_dropout=0.0, device="cpu")
    system = mtl.system
    assert system.fused_layout == "slice"
    for name in ("reason_multi", "reason_concat"):
        monkeypatch.setattr(type(system.backbone), name, spy(name))
    logs = mtl(1e-3)
    assert calls == ["reason_multi"]
    assert all(bool(torch.isfinite(v).all()) for v in logs.values())
    monkeypatch.delenv("EGOPACK_FUSED_LAYOUT")
    assert build_mtl_step(2, 16, 32, device="cpu").system.fused_layout \
        == "auto"


def _cli(args, cwd, timeout=300):
    # one thread, as in this process: the suite runs beside other workers
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stderr


def test_cli_runs_the_verify_phase2_command(ego4d_root, tmp_path):
    """The verify notes' phase-2 command with ``device=cpu``, as a user types
    it, from a phase-1 artifact of the port's CLI; then the cold
    evaluation of its artifact. JAX's ``load_artifact`` reads it."""
    widths = ["model.hidden_size=32", "model.temporal_pooling.hidden_size=32",
              "oscc_feat_size=32", "batch_size=4", "num_workers=0",
              "validation_split=val", f"dataset_recognition.root={ego4d_root}",
              f"dataset_oscc.root={ego4d_root}",
              f"dataset_lta.root={ego4d_root}",
              f"dataset_pnr.root={ego4d_root}",
              f"artifact_dir={tmp_path}/artifacts",
              f"output_dir={tmp_path}/outputs", "parallel.data=1",
              "device=cpu"]
    tmain_temporal.main(["seed=1", "k=1", "num_epochs=1", "save_model=True",
                         "enabled_tasks=[ar,lta,pnr]", *widths])
    log = _cli(["egopack_torch.main_egopack", "enable_graphone=True",
                "enabled_tasks=[oscc]", f"resume_from={MTL}", "graphone.k=2",
                "graphone.hidden_size=32", "graphone.residual=True",
                "num_epochs=2", "optimizer.lr=1e-6", "save_model=True",
                *widths], REPO)
    assert "Built prototype banks for ('ar', 'lta', 'pnr')" in log
    assert log.count("Epoch ") == 2 and log.count(" ## OSCC ## ") == 2
    assert f"Saved artifact {NOVEL}" in log
    payload, meta = jckpt.load_artifact(f"{tmp_path}/artifacts", NOVEL)
    assert meta["phase"] == "egopack" and meta["tasks"] == ["oscc"]
    assert payload["graphone_bank_masks"]["ar"].dtype == np.bool_
    out = tmp_path / "metrics.json"
    log = _cli(["egopack_torch.evaluate", f"resume_from={NOVEL}",
                f"output={out}", *widths], REPO)
    assert " ## OSCC ## " in log
    with open(out) as f:
        cold = json.load(f)
    assert sorted(cold) == ["oscc"]
    assert 0.0 <= cold["oscc"]["accuracy"] <= 1.0


@pytest.mark.parametrize("phase", ["mtl", "egopack_without_banks"])
def test_unpack_artifact_without_banks(runs, phase):
    """A phase-1 payload passes through as parameters; a phase-2 payload
    without its banks cannot be evaluated cold and raises (JAX asserts)."""
    from egopack_torch.config import compose, default_config_dir
    cfg = compose(default_config_dir(), "defaults",
                  overrides=base(runs["root"], runs["tmp"]["port"]))
    payload, meta = tckpt.load_artifact(f"{runs['tmp']['port']}/artifacts",
                                        MTL if phase == "mtl" else NOVEL)
    if phase == "mtl":
        out = tckpt.unpack_artifact(payload, meta, cfg, "cpu")
        assert out == (False, None, None, (), True, {})
        assert "epoch" not in payload and "temporal_graph" in payload
    else:
        del payload["graphone_banks"]
        with pytest.raises(ValueError, match="lacks prototype banks"):
            tckpt.unpack_artifact(payload, meta, cfg, "cpu")
