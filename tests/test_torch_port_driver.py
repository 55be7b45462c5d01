"""The phase-1 slice as a whole: the port's CLI against the JAX package's
``main_temporal`` on the same fixture, from the same initial parameters
(JAX's, carried in by ``interop.from_flax``), dropout off.

Per-epoch train losses and norms from ``metrics.jsonl`` agree at rtol 1e-4;
the AR and PNR validation metrics agree (accuracies exactly, losses rtol
1e-4); the LTA loss at rtol 1e-4, its edit distances (other samples) in
range; the artifact has JAX's name and meta, and JAX's ``load_artifact``
reads it to leaves within rtol 1e-4 / atol 1e-5 of JAX's own. A run resumed
from an epoch-1 checkpoint equals the straight run bit for bit. The CLI
runs as ``python -m egopack_torch.main_temporal`` with the phase-1 command
of the verify notes.

The step options run against JAX's CLI too, from the same initial
parameters: ``log_per_layer_norms`` (every per-layer norm of
``metrics.jsonl`` at rtol 1e-4), ``log_histograms_every`` (the
``histograms_ep<n>.npz`` files: the same arrays, whose values agree at
rtol 1e-4 / atol 1e-5, so edges within that and counts that differ only
by values that close to an edge) and
``+model.propagate_dtype=bfloat16`` (losses and norms at one bf16 unit,
rtol 2**-7: the forward passes round at the same places, but the backward
passes sum some bf16 gradients in another order, one to four bf16 units
apart in an element of a gradient)."""

import json
import logging
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import main_temporal as jmain
from egopack_torch import interop
from egopack_torch import main_temporal as tmain
from egopack_torch.data.synthetic import generate_ego4d_fixture
from egopack_torch.train import checkpoint as tckpt
from egopack_torch.train import system as tsystem
from egopack_tpu.train import checkpoint as jckpt
from egopack_tpu.train import system as jsystem
from torch_port_common import (BF16_UNIT, assert_histogram_files_match,
                               assert_train_records_match, by_epoch, records,
                               to_np)

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
ARTIFACT = "MTL_ar-lta-pnr"


def overrides(root, tmp, *extra):
    """tests/test_end_to_end.py's phase-1 overrides, dropout off, two
    epochs of steps_per_call=2 groups."""
    return ["seed=1", "k=1", "num_epochs=2", "batch_size=4", "num_workers=0",
            "model.hidden_size=32", "model.temporal_pooling.hidden_size=32",
            "oscc_feat_size=32", "model.temporal_pooling.dropout=0",
            "model.depth=2", "save_model=True",
            f"dataset_recognition.root={root}", f"dataset_oscc.root={root}",
            f"dataset_lta.root={root}", f"dataset_pnr.root={root}",
            "validation_split=val", f"artifact_dir={tmp}/artifacts",
            f"output_dir={tmp}/outputs", "parallel.data=1", "parallel.model=1",
            "enabled_tasks=[ar,lta,pnr]", "steps_per_call=2", *extra]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def capture_jax_init(mp, init):
    """Record JAX's initial parameters in ``init`` and start the port's
    system from them."""
    orig = jsystem.MultiTaskSystem.init_params

    def capture(self, rng, feat_dim):
        params = orig(self, rng, feat_dim)
        init["params"] = to_np(params)
        return params

    def jax_init(self, generator):
        self.load_state({k: v.to(self.device) for k, v in
                         interop.from_flax(init["params"]).items()})
        return self.params()

    mp.setattr(jsystem.MultiTaskSystem, "init_params", capture)
    mp.setattr(tsystem.MultiTaskSystem, "init_params", jax_init)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ego4d"))
    generate_ego4d_fixture(root, feature_dim=16, seed=2)
    tmp = {k: str(tmp_path_factory.mktemp(k))
           for k in ("jax", "port", "straight", "resumed")}
    init = {}
    mp = pytest.MonkeyPatch()
    handler = _Lines()
    port_logger = logging.getLogger("egopack_torch")
    port_logger.addHandler(handler)
    level = port_logger.level
    port_logger.setLevel(logging.INFO)
    try:
        capture_jax_init(mp, init)
        jres = jmain.main(overrides(root, tmp["jax"]))
        tres = tmain.main(overrides(root, tmp["port"], "device=cpu"))
        lines = list(handler.lines)
        # the resume check runs with dropout on, so that the restored
        # generator state matters
        drop = ("device=cpu", "model.temporal_pooling.dropout=0.5",
                f"checkpoint.dir={tmp['resumed']}/ckpt")
        straight = tmain.main(overrides(root, tmp["straight"], *drop))
        first = tmain.main(overrides(root, tmp["resumed"], *drop,
                                     "num_epochs=1", "checkpoint.enable=True"))
        resumed = tmain.main(overrides(root, tmp["resumed"], *drop,
                                       "checkpoint.enable=True"))
    finally:
        mp.undo()
        port_logger.removeHandler(handler)
        port_logger.setLevel(level)
    return dict(root=root, tmp=tmp, jres=jres, tres=tres, lines=lines,
                straight=straight, first=first, resumed=resumed)


def test_train_losses_and_norms_match_jax(runs):
    ours = by_epoch(records(runs["tres"]["run_dir"]), "train/")
    ref = by_epoch(records(runs["jres"]["run_dir"]), "train/")
    assert sorted(ours) == sorted(ref) == [1, 2]
    for epoch in ref:
        assert set(ours[epoch]) == set(ref[epoch])
        for k, v in ref[epoch].items():
            np.testing.assert_allclose(ours[epoch][k], v, rtol=1e-4,
                                       err_msg=f"epoch {epoch} {k}")


def test_validation_metrics_match_jax(runs):
    ours = by_epoch(records(runs["tres"]["run_dir"]), "val/")
    ref = by_epoch(records(runs["jres"]["run_dir"]), "val/")
    assert sorted(ours) == sorted(ref) == [1, 2]
    for epoch in ref:
        assert set(ours[epoch]) == set(ref[epoch])
        for k, v in ref[epoch].items():
            what = f"epoch {epoch} {k}"
            if k.startswith("val/lta/") and k.endswith("_ed"):
                assert 0.0 <= ours[epoch][k] <= 1.0, what
            elif k.endswith(("loss", "calibration_error", "brier_score",
                             "auroc")):
                np.testing.assert_allclose(ours[epoch][k], v, rtol=1e-4,
                                           err_msg=what)
            else:
                assert ours[epoch][k] == v, what


def test_artifact_matches_jax(runs):
    tmp = runs["tmp"]
    assert runs["tres"]["artifact"] == runs["jres"]["artifact"] == ARTIFACT
    ours, ours_meta = jckpt.load_artifact(f"{tmp['port']}/artifacts", ARTIFACT)
    ref, ref_meta = jckpt.load_artifact(f"{tmp['jax']}/artifacts", ARTIFACT)
    assert ours_meta == ref_meta == {"tasks": ["ar", "lta", "pnr"],
                                     "num_epochs": 2}
    assert int(ours.pop("epoch")) == int(ref.pop("epoch")) == 2
    ours_t, ref_t = interop.from_flax(ours), interop.from_flax(ref)
    assert set(ours_t) == set(ref_t)
    for name, v in ref_t.items():
        np.testing.assert_allclose(ours_t[name].numpy(), v.numpy(), **TOL,
                                   err_msg=name)
    # the port's own reader gives the in-memory parameters bit for bit
    loaded, _ = tckpt.load_artifact(f"{tmp['port']}/artifacts", ARTIFACT)
    loaded.pop("epoch")
    params = runs["tres"]["system"].params()
    for name, v in interop.from_flax(loaded).items():
        assert torch.equal(v, params[name].detach()), name


def test_log_lines(runs):
    text = "\n".join(runs["lines"])
    for needle in ("Epoch   1/2 (15 steps", "Epoch   2/2 (15 steps",
                   " ## Recognition ## ", " ## LTA ## ", " ## PNR ## ",
                   "Verbs Top-1:", "localization_error:", "verbs_ed:",
                   "Saved artifact MTL_ar-lta-pnr"):
        assert needle in text, needle


def test_epoch_stats_carry_the_step_spans(runs):
    """A one-epoch run's stats and log line: the median host ms of the train
    step and of its phases (``egopack_torch.tracing``), the seconds in
    pinned copies, the data wait read from its span."""
    (stats,) = runs["first"]["epochs"]
    host_ms = stats["host_ms"]
    assert set(host_ms) == {"step", "forward", "backward", "norms",
                            "optimizer"}
    assert all(v > 0 for v in host_ms.values())
    # every step's span holds its phases' spans
    assert host_ms["step"] >= max(host_ms[p] for p in host_ms if p != "step")
    assert 0 < stats["h2d_s"] <= stats["data_s"] <= stats["train_s"]
    text = "\n".join(runs["lines"])
    assert "host ms a step (median): {'step': " in text
    assert "s in pinned copies" in text


def test_resumed_run_equals_straight_run(runs):
    assert runs["first"]["start_epoch"] == 1
    assert runs["resumed"]["start_epoch"] == 2
    assert [s["epoch"] for s in runs["resumed"]["epochs"]] == [2]
    a = runs["straight"]["system"].params()
    b = runs["resumed"]["system"].params()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    sa, sb = runs["straight"]["opt_state"], runs["resumed"]["opt_state"]
    assert sa.count == sb.count == 30
    for name in sa.mu:
        assert torch.equal(sa.mu[name], sb.mu[name]), name
        assert torch.equal(sa.nu[name], sb.nu[name]), name
    la = by_epoch(records(runs["straight"]["run_dir"]), "train/")[2]
    lb = by_epoch(records(runs["resumed"]["run_dir"]), "train/")[2]
    assert la == lb


def test_unsupported_settings_raise(runs, monkeypatch):
    """A grid larger than the world of processes raises, and so does a
    multi-process run without its rendezvous: nothing carries on alone."""
    base = overrides(runs["root"], runs["tmp"]["port"], "device=cpu",
                     "num_epochs=1", "save_model=False")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for extra, match in ((["parallel.data=2"], "number of processes"),
                         (["parallel.multihost=True"], "env://")):
        with pytest.raises(ValueError, match=match):
            tmain.main(base + extra)
    # the configs' device=tpu means the card; without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(base + ["device=tpu"])


def test_profile_trace_and_confusion_tables(runs, tmp_path):
    import glob
    trace = tmp_path / "trace"
    result = tmain.main(overrides(runs["root"], str(tmp_path), "device=cpu",
                                  "num_epochs=1", "save_model=False",
                                  f"profile_dir={trace}",
                                  "log_confusion_matrices=True"))
    with open(trace / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    tables = glob.glob(osp.join(result["run_dir"], "confusion_ar_ep1.json"))
    with open(tables[0]) as f:
        got = json.load(f)
    assert set(got) == {"verbs", "nouns"}
    assert set(got["verbs"]) == {"top2_confusion", "class_acc"}


def test_cli_runs_the_verify_phase1_command(ego4d_root, tmp_path):
    """The phase-1 command of the repository's verify notes with
    ``device=cpu``, as a user types it; JAX's ``load_artifact`` reads the
    artifact."""
    cmd = [sys.executable, "-m", "egopack_torch.main_temporal", "seed=1", "k=1",
           "num_epochs=7", "batch_size=4", "num_workers=0",
           "model.hidden_size=32", "model.temporal_pooling.hidden_size=32",
           "oscc_feat_size=32", "save_model=True", "enabled_tasks=[ar,lta,pnr]",
           "validation_split=val", f"dataset_recognition.root={ego4d_root}",
           f"dataset_oscc.root={ego4d_root}", f"dataset_lta.root={ego4d_root}",
           f"dataset_pnr.root={ego4d_root}",
           f"artifact_dir={tmp_path}/artifacts",
           f"output_dir={tmp_path}/outputs", "parallel.data=1", "device=cpu"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    log = proc.stderr
    assert log.count("Epoch ") == 7 and log.count(" ## PNR ## ") == 6
    assert "Saved artifact MTL_ar-lta-pnr" in log
    payload, meta = jckpt.load_artifact(f"{tmp_path}/artifacts", ARTIFACT)
    assert meta == {"tasks": ["ar", "lta", "pnr"], "num_epochs": 7}
    assert int(payload["epoch"]) == 7
    for key in ("temporal_graph", "task/recognition", "task/oscc", "task/lta",
                "task/pnr"):
        assert key in payload, key


OPTIONS = {"norms_and_histograms": ("log_per_layer_norms=True",
                                    "log_histograms_every=1"),
           "bf16": ("+model.propagate_dtype=bfloat16",),
           "encoding": ("model.temporal_pooling.encoding=learnt",)}


@pytest.fixture(scope="module")
def option_runs(runs, tmp_path_factory):
    """JAX's CLI and the port's with each set of ``OPTIONS``, two epochs
    from the same initial parameters, dropout off."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        init = {}
        capture_jax_init(mp, init)
        for name, extra in OPTIONS.items():
            tmp = {k: str(tmp_path_factory.mktemp(f"{name}_{k}"))
                   for k in ("jax", "port")}
            out[name] = (
                jmain.main(overrides(runs["root"], tmp["jax"], *extra,
                                     "save_model=False")),
                tmain.main(overrides(runs["root"], tmp["port"], *extra,
                                     "save_model=False", "device=cpu")))
    finally:
        mp.undo()
    return out


def test_per_layer_norms_match_jax(option_runs):
    jres, tres = option_runs["norms_and_histograms"]
    ref = assert_train_records_match(tres, jres, rtol=1e-4)
    assert "train/grad_norm/temporal_graph/sage0" in ref[1]
    assert "train/param_norm/task/recognition/cls0" in ref[1]


def test_histograms_match_jax(option_runs):
    jres, tres = option_runs["norms_and_histograms"]
    assert_histogram_files_match(tres["run_dir"], jres["run_dir"], (1, 2))


def test_propagate_dtype_bf16_matches_jax(option_runs):
    jres, tres = option_runs["bf16"]
    assert tres["system"].backbone.propagate_dtype == torch.bfloat16
    assert_train_records_match(tres, jres, rtol=BF16_UNIT)


def test_pooling_encoding_matches_jax(option_runs):
    """``model.temporal_pooling.encoding=learnt`` in both CLIs from JAX's
    initial parameters (its ``frame_encoding`` and ``encoding_mlp``
    included): losses and norms at rtol 1e-4."""
    jres, tres = option_runs["encoding"]
    pooling = tres["system"].backbone.pooling
    assert pooling.encoding == "learnt"
    assert "temporal_graph.pooling.frame_encoding" in tres["system"].params()
    assert_train_records_match(tres, jres, rtol=1e-4)


def dropout_run(runs, tmp, *extra):
    """The resume check's settings (dropout on) on directories of ``tmp``."""
    return overrides(runs["root"], tmp, "device=cpu",
                     "model.temporal_pooling.dropout=0.5",
                     f"checkpoint.dir={tmp}/ckpt", *extra)


def assert_runs_equal(a, b):
    pa, pb = a["system"].params(), b["system"].params()
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
    for name in a["opt_state"].mu:
        assert torch.equal(a["opt_state"].mu[name], b["opt_state"].mu[name])
        assert torch.equal(a["opt_state"].nu[name], b["opt_state"].nu[name])
    ra, rb = (by_epoch(records(r["run_dir"]), "train/") for r in (a, b))
    assert ra[max(ra)] == rb[max(rb)]


@pytest.fixture(scope="module")
def in_process_run(runs, tmp_path_factory):
    """The straight run's settings from the port's own initial parameters,
    loaders in this process."""
    return tmain.main(dropout_run(runs, str(tmp_path_factory.mktemp("ip"))))


def test_pooled_run_equals_in_process_run(runs, in_process_run, tmp_path):
    """``loader_processes=2``: two forked workers a loader give the
    in-process run's trajectory bit for bit, its validation too; the pools
    are stopped when the run ends."""
    pooled = tmain.main(dropout_run(runs, str(tmp_path), "loader_processes=2"))
    assert_runs_equal(pooled, in_process_run)
    for prefix in ("train/", "val/"):
        assert by_epoch(records(pooled["run_dir"]), prefix) == by_epoch(
            records(in_process_run["run_dir"]), prefix)
    loaders = [d[k] for d in pooled["dsets"].values()
               for k in ("dl_train", "dl_val")]
    assert all(dl.num_workers == 2 and dl._procs == [] for dl in loaders)


def test_resume_from_async_checkpoint_equals_straight_run(
        runs, in_process_run, tmp_path):
    """``checkpoint.async_write=True``: the epoch-1 checkpoint, written in
    the background, resumes to the straight run bit for bit."""
    extra = ("checkpoint.enable=True", "checkpoint.async_write=True")
    first = tmain.main(dropout_run(runs, str(tmp_path), "num_epochs=1",
                                   *extra))
    assert tckpt.latest_state(f"{tmp_path}/ckpt/mtl_{ARTIFACT}") == 1
    resumed = tmain.main(dropout_run(runs, str(tmp_path), *extra))
    assert first["start_epoch"] == 1 and resumed["start_epoch"] == 2
    assert_runs_equal(resumed, in_process_run)
