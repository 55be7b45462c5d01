"""The port's tools against the JAX package's, on the same inputs:
``sweep.build_commands`` on every experiment YAML (equal to JAX's but for
the program, which becomes ``-m egopack_torch.main_*``) and the CLI's
``--dry-run``; ``aggregate`` on the same run directories; the confusion
tables and heatmaps of ``utils/plots`` (skipped with a warning without
matplotlib); ``MetricSelectorWrapper``'s three cases; the ``EGOPACK_WANDB``
passthrough of ``RunLogger`` into a stub module; and the three pooling
encodings with weights carried across by ``interop`` (rtol 1e-5)."""

import builtins
import glob
import json
import logging
import os.path as osp
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from egopack_torch import aggregate as taggregate
from egopack_torch import interop
from egopack_torch import sweep as tsweep
from egopack_torch.models.pooling import TRNPooling
from egopack_torch.ops.criterion import MetricSelectorWrapper
from egopack_torch.utils import logging as tlogging
from egopack_torch.utils import plots as tplots
from egopack_tpu import aggregate as jaggregate
from egopack_tpu import sweep as jsweep
from egopack_tpu.models import pooling as jpooling
from egopack_tpu.ops import criterion as jcriterion
from egopack_tpu.utils import plots as jplots

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
EXPERIMENTS = sorted(glob.glob(osp.join(REPO, "experiments", "**", "*.yaml"),
                               recursive=True))
MODULES = {"main_temporal.py": "egopack_torch.main_temporal",
           "main_egopack.py": "egopack_torch.main_egopack"}


# ---- sweep ----

@pytest.mark.parametrize("path", EXPERIMENTS,
                         ids=[osp.relpath(p, REPO) for p in EXPERIMENTS])
def test_sweep_commands_match_jax(path):
    """The port's YAML reader gives PyYAML's spec; each command is JAX's
    with ``<program>`` replaced by ``-m <the port's module>``."""
    with open(path) as f:
        spec = yaml.safe_load(f)
    assert tsweep.load_file(path) == spec
    extra = ["num_epochs=1", "device=cpu"]
    ours = tsweep.build_commands(spec, extra)
    ref = jsweep.build_commands(spec, extra)
    assert len(ours) == len(ref) > 0
    for o, r in zip(ours, ref):
        assert o[:3] == [sys.executable, "-m", MODULES[r[1]]]
        assert o[3:] == r[2:]


def test_sweep_drops_every_wandb_placeholder_and_unknown_programs():
    spec = {"program": "main_temporal.py",
            "command": ["${env}", "${interpreter}", "${program}", "${args}"],
            "parameters": {"seed": {"values": [1, 2]}}}
    cmds = tsweep.build_commands(spec)
    assert cmds == [[sys.executable, "-m", "egopack_torch.main_temporal",
                     f"seed={s}"] for s in (1, 2)]
    with pytest.raises(ValueError, match="the port runs"):
        tsweep.build_commands(dict(spec, program="main.py"))


def test_sweep_dry_run_cli():
    proc = subprocess.run(
        [sys.executable, "-m", "egopack_torch.sweep", "experiments/mtl.yaml",
         "--dry-run", "device=cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "Sweep 'Ego4d - MTL (AR, OSCC, LTA, PNR)': 4 runs"
    runs = lines[1:]
    assert len(runs) == 4
    for line in runs:
        assert " -m egopack_torch.main_temporal " in line
        assert "main_temporal.py" not in line and line.endswith("device=cpu")


# ---- aggregate ----

@pytest.fixture()
def run_dirs(tmp_path):
    """Runs of two swept depths over three seeds, written by the port's
    ``RunLogger`` (one directory each), and a directory that is not a run."""
    for depth in (1, 3):
        for seed, acc in ((65, 0.70), (72, 0.72), (97, 0.74)):
            logger = tlogging.RunLogger(
                str(tmp_path), f"OSCC_depth-{depth}",
                {"seed": seed, "enabled_tasks": ["oscc"],
                 "graphone": {"depth": depth, "k": 4}, "lr": 1e-6})
            logger.log({"val/oscc/accuracy": 0.5, "train/oscc/loss": 0.9},
                       step=1)
            logger.log({"val/oscc/accuracy": acc + depth / 100,
                        "train/oscc/loss": 0.6 - depth / 10, "note": "x"},
                       step=2)
            logger.close()
    (tmp_path / "not_a_run").mkdir()
    return str(tmp_path)


def test_aggregate_matches_jax(run_dirs):
    ours, ref = taggregate.aggregate(run_dirs), jaggregate.aggregate(run_dirs)
    assert ours == ref
    assert len(ours) == 2
    for label, metrics in ours.items():
        assert "(seeds [65, 72, 97])" in label
        assert metrics["val/oscc/accuracy"]["n"] == 3
    depth1 = next(m for l, m in ours.items() if "graphone.depth=1" in l)
    assert depth1["val/oscc/accuracy"]["mean"] == pytest.approx(0.73)
    only = taggregate.aggregate(run_dirs, "train/oscc/loss")
    assert only == jaggregate.aggregate(run_dirs, "train/oscc/loss")
    assert all(list(m) == ["train/oscc/loss"] for m in only.values())


def test_aggregate_cli_prints_each_group(run_dirs, capsys):
    result = taggregate.main([run_dirs, "--metric", "val/oscc/accuracy"])
    out = capsys.readouterr().out
    assert out.count("== oscc [graphone.depth=") == 2
    assert "val/oscc/accuracy: 0.7300 ± 0.0163 (n=3)" in out
    assert result == jaggregate.aggregate(run_dirs, "val/oscc/accuracy")


# ---- plots ----

def test_confusion_tables_match_jax():
    rng = np.random.default_rng(1)
    cm = rng.integers(0, 6, size=(12, 12)).astype(np.float64)
    cm[3] = 0  # an empty row
    labels = [f"v{i}" for i in range(12)]
    for normalize in (False, True):
        assert tplots.generate_confusion_table(cm, labels, normalize) == \
            jplots.generate_confusion_table(cm, labels, normalize)
    np.testing.assert_array_equal(tplots._normalize(cm), jplots._normalize(cm))
    assert tplots.generate_confusion_table(np.eye(3) * 5, list("abc")) == \
        [("a --> a", 1), ("b --> b", 1), ("c --> c", 1)]
    assert tplots.heatmap_path("/r", "ar", "verbs", 3) == \
        jplots.heatmap_path("/r", "ar", "verbs", 3)


def test_heatmap_is_written(tmp_path):
    cm = np.arange(16, dtype=np.float64).reshape(4, 4)
    png = tmp_path / "cm.png"
    assert tplots.save_confusion_heatmap(cm, str(png))
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_heatmap_skipped_with_a_warning_without_matplotlib(
        tmp_path, monkeypatch, caplog):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    png = tmp_path / "cm.png"
    with caplog.at_level(logging.WARNING):
        assert not tplots.save_confusion_heatmap(np.eye(3), str(png))
    assert not png.exists()
    assert "matplotlib unavailable" in caplog.text
    # the tables need numpy only
    assert tplots.generate_confusion_table(np.eye(2), ["a", "b"], False) == \
        [("a --> a", 1), ("b --> b", 1)]


# ---- criterion ----

class _FakeDS:
    def __init__(self, joint):
        self.has_joint_label = joint


@pytest.mark.parametrize("joint,joint_training", [(False, False),
                                                  (True, False),
                                                  (True, True),
                                                  (False, True)])
def test_metric_selector_wrapper_matches_jax(joint, joint_training):
    """tests/test_train_infra.py:101-107's three cases (no joint label: all
    heads; joint label, flag off: all but the joint head; joint training:
    the joint head only), and the flag without a joint label, which falls
    back to all heads. Per-element losses at rtol 1e-5, ignored labels
    (-1) included."""
    rng = np.random.default_rng(0)
    logits = [rng.normal(size=(5, c)).astype(np.float32) for c in (4, 3, 6)]
    targets = np.stack([rng.integers(-1, c, 5) for c in (4, 3, 6)], -1)
    ours = MetricSelectorWrapper(dataset=_FakeDS(joint),
                                 joint_label_training=joint_training)(
        [torch.from_numpy(l) for l in logits], torch.from_numpy(targets))
    ref = jcriterion.MetricSelectorWrapper(
        dataset=_FakeDS(joint), joint_label_training=joint_training)(
        [jnp.asarray(l) for l in logits], jnp.asarray(targets))
    assert ours.shape == (5,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="must match"):
        MetricSelectorWrapper()([torch.from_numpy(logits[0])],
                                torch.from_numpy(targets))


def test_metric_selector_wrapper_routing():
    logits = (torch.tensor([[2.0, 1.0]]), torch.tensor([[0.5, 1.5]]),
              torch.tensor([[3.0, 0.0]]))
    targets = torch.tensor([[0, 1, 0]])
    all_sum = float(MetricSelectorWrapper(dataset=_FakeDS(False))(
        logits, targets)[0])
    two = float(MetricSelectorWrapper(dataset=_FakeDS(True))(
        logits, targets)[0])
    one = float(MetricSelectorWrapper(dataset=_FakeDS(True),
                                      joint_label_training=True)(
        logits, targets)[0])
    assert all_sum > two > one > 0
    assert all_sum == pytest.approx(two + one, rel=1e-6)


# ---- wandb ----

def test_wandb_passthrough_into_a_stub(tmp_path, monkeypatch):
    """``EGOPACK_WANDB=1``: a stub ``wandb`` module gets the run's init,
    every record and the finish."""
    calls = []

    class Run:
        def log(self, metrics, step=None):
            calls.append(("log", dict(metrics), step))

        def finish(self):
            calls.append(("finish",))

    stub = types.ModuleType("wandb")

    def init(**kwargs):
        calls.append(("init", kwargs))
        return Run()

    stub.init = init
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.setenv("EGOPACK_WANDB", "1")
    monkeypatch.setenv("WANDB_PROJECT", "proj")
    logger = tlogging.RunLogger(str(tmp_path), "run", {"seed": 1})
    logger.log({"train/ar/loss": 0.5}, step=1)
    logger.close()
    assert calls == [
        ("init", {"project": "proj", "name": "run", "config": {"seed": 1},
                  "dir": logger.dir}),
        ("log", {"train/ar/loss": 0.5}, 1), ("finish",)]
    with open(osp.join(logger.dir, "metrics.jsonl")) as f:
        assert json.loads(f.readline())["train/ar/loss"] == 0.5


def test_wandb_missing_logs_a_warning(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises
    monkeypatch.setenv("EGOPACK_WANDB", "1")
    with caplog.at_level(logging.WARNING):
        logger = tlogging.RunLogger(str(tmp_path), "run", {"seed": 1})
    logger.log({"m": 1.0}, step=1)
    logger.close()
    assert "wandb passthrough unavailable" in caplog.text
    monkeypatch.delenv("EGOPACK_WANDB")
    assert tlogging.RunLogger(str(tmp_path), "off")._wandb is None


# ---- pooling encodings ----

@pytest.mark.parametrize("encoding", ["learnt", "positional", "temporal"])
def test_pooling_encoding_matches_jax(encoding):
    """``TRNPooling(encoding=...)`` with JAX's weights (``frame_encoding``,
    ``encoding_mlp`` and the MLP) carried across by ``interop``: outputs
    at rtol 1e-5 / atol 1e-6; ``to_flax`` gives JAX's tree back."""
    feat, segs, hidden, out = 16, 3, 32, 24
    jmod = jpooling.TRNPooling(input_size=feat, output_size=out,
                               num_segments=segs, hidden_size=hidden,
                               encoding=encoding)
    x = np.random.default_rng(1).normal(size=(2, 5, segs, feat)).astype(
        np.float32)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = TRNPooling(feat, out, segs, hidden_size=hidden, encoding=encoding,
                      device="cpu")
    tmod.load_state_dict(interop.from_flax(params), strict=True)
    with torch.no_grad():
        ours = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    back = interop.to_flax(dict(tmod.named_parameters()))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    if encoding == "learnt":
        g = torch.Generator().manual_seed(0)
        tmod.reset_parameters(g)
        table = tmod.frame_encoding.detach()
        assert table.min() >= 0.0 and table.max() < 1.0 and table.std() > 0


def test_pooling_encoding_unknown_raises():
    with pytest.raises(ValueError, match="Unsupported encoding"):
        TRNPooling(4, 4, 3, hidden_size=8, encoding="rotary", device="cpu")
