"""The port's challenge predictions against ``egopack_tpu.predict`` on the
same flax-format artifacts (``MTL_ar-lta-pnr`` of phase 1 and the phase-2
``MTL_oscc``, written by the port's drivers, which JAX's ``load_artifact``
reads as its own: ``tests/test_torch_port_driver_phase2.py``), on the
fixture's ``test_unannotated`` split.

OSCC: the same keys, ``prob_change`` at rtol 1e-5 / atol 1e-6, and the
same decision wherever the two probabilities lie further apart than that
(a decision closer to its margin could flip with the order of the sums; no
sample of this fixture is left out so, and the test counts them). PNR: the
same keys and ``pnr_frame`` equal wherever the best node leads the second
by more than 1e-5 in the logits (likewise counted). LTA: the same keys,
K=5 sequences of 20 a head with class indices in range (the samples come
from a torch generator, JAX's from its keys: they agree in distribution
only, which ``tests/test_torch_port_eval.py`` checks)."""

import json
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from egopack_torch import main_egopack as tmain_egopack
from egopack_torch import main_temporal as tmain_temporal
from egopack_torch import predict as tpredict
from egopack_torch.config import compose, default_config_dir
from egopack_torch.data.synthetic import generate_ego4d_fixture
from egopack_torch.eval.validate import to_host
from egopack_tpu import predict as jpredict

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
MTL, NOVEL = "MTL_ar-lta-pnr", "MTL_oscc"
TOL = dict(rtol=1e-5, atol=1e-6)


def base(root, tmp, *extra):
    return ["seed=1", "k=1", "batch_size=4", "num_workers=0",
            "model.hidden_size=32", "model.temporal_pooling.hidden_size=32",
            "oscc_feat_size=32", "model.depth=2",
            f"dataset_recognition.root={root}", f"dataset_oscc.root={root}",
            f"dataset_lta.root={root}", f"dataset_pnr.root={root}",
            f"artifact_dir={tmp}/artifacts", f"output_dir={tmp}/outputs",
            "parallel.data=1", "parallel.model=1", *extra]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Phase-1 and phase-2 artifacts, one epoch each, trained by the port
    on the CPU (JAX's drivers take a minute to compile the same runs)."""
    root = str(tmp_path_factory.mktemp("ego4d"))
    generate_ego4d_fixture(root, feature_dim=16, seed=4)
    tmp = str(tmp_path_factory.mktemp("artifacts"))
    tmain_temporal.main(base(root, tmp, "num_epochs=1", "save_model=True",
                             "validation_split=val", "device=cpu",
                             "enabled_tasks=[ar,lta,pnr]"))
    tmain_egopack.main(base(root, tmp, "num_epochs=1", "save_model=True",
                            "validation_split=val", "enable_graphone=True",
                            "enabled_tasks=[oscc]", f"resume_from={MTL}",
                            "graphone.k=2", "graphone.depth=1",
                            "graphone.hidden_size=32", "optimizer.lr=1e-3",
                            "device=cpu"))
    return root, tmp


def predict_both(artifacts, task, artifact, out_dir, split="test_unannotated"):
    root, tmp = artifacts
    args = base(root, tmp, f"resume_from={artifact}",
                f"validation_split={split}")
    jpredict.main(args + [f"task={task}", f"output={out_dir}/jax.json"])
    ours = tpredict.main(args + ["device=cpu", f"task={task}",
                                 f"output={out_dir}/port.json"])
    with open(f"{out_dir}/jax.json") as f:
        ref = json.load(f)
    with open(f"{out_dir}/port.json") as f:
        assert json.load(f) == ours
    return ours, ref, args


@pytest.mark.parametrize("artifact", [MTL, NOVEL])
def test_oscc_matches_jax(artifacts, artifact, tmp_path):
    ours, ref, _ = predict_both(artifacts, "oscc", artifact, tmp_path)
    assert sorted(ours) == sorted(ref) and len(ref) > 0
    assert all(k.startswith("oscc_test_unannotated_") for k in ours)
    near = 0
    for uid, r in ref.items():
        o = ours[uid]
        np.testing.assert_allclose(o["prob_change"], r["prob_change"], **TOL,
                                   err_msg=uid)
        assert 0.0 <= o["prob_change"] <= 1.0
        if abs(2 * r["prob_change"] - 1) <= 1e-5:
            near += 1  # the decision may flip with the order of the sums
            continue
        assert o["state_change"] == r["state_change"], uid
    assert near == 0


def test_pnr_matches_jax(artifacts, tmp_path):
    ours, ref, args = predict_both(artifacts, "pnr", MTL, tmp_path)
    assert sorted(ours) == sorted(ref) and len(ref) > 0
    # each sample's logits, to tell near-ties apart
    cfg = compose(default_config_dir(), "defaults",
                  [a for a in args] + ["device=cpu"])
    p = tpredict.Predictor(cfg, "pnr")
    lead = {}
    for batch, dbatch in p.batches():
        (logits,) = to_host([p.eval_step(dbatch, p.banks)[0]])
        top2 = np.sort(logits, -1)[:, -2:]
        for b, valid in enumerate(batch["valid"]):
            if valid:
                lead[str(batch["uid"][b])] = float(top2[b, 1] - top2[b, 0])
    assert sorted(lead) == sorted(ref)
    near = [u for u, d in lead.items() if d <= 1e-5]
    for uid, r in ref.items():
        if uid not in near:
            assert ours[uid]["pnr_frame"] == r["pnr_frame"], uid
    assert near == []
    starts = {u: b for u, b in ((str(batch["uid"][i]),
                                 (float(batch["start_frame"][i]),
                                  float(batch["end_frame"][i])))
                                for batch, _ in p.batches()
                                for i in range(len(batch["valid"]))
                                if batch["valid"][i])}
    for uid, o in ours.items():
        lo, hi = starts[uid]
        assert lo <= o["pnr_frame"] <= hi, uid


def test_lta_keys_and_shapes_match_jax(artifacts, tmp_path):
    ours, ref, _ = predict_both(artifacts, "lta", MTL, tmp_path)
    assert sorted(ours) == sorted(ref) and len(ref) > 0
    for key, o in ours.items():
        for head, n_classes in (("verb", 12), ("noun", 9)):
            seqs = np.asarray(o[head])
            assert seqs.shape == np.asarray(ref[key][head]).shape == (5, 20)
            assert seqs.min() >= 0 and seqs.max() < n_classes


def test_lta_samples_follow_the_seed(artifacts, tmp_path):
    root, tmp = artifacts
    args = base(root, tmp, f"resume_from={MTL}",
                "validation_split=test_unannotated", "device=cpu",
                "task=lta")
    a = tpredict.main(args + [f"output={tmp_path}/a.json"])
    b = tpredict.main(args + [f"output={tmp_path}/b.json"])
    c = tpredict.main(args + ["seed=2", f"output={tmp_path}/c.json"])
    assert a == b and a != c


def test_oscc_on_val_matches_the_meter(artifacts, tmp_path):
    """On a labelled split the decisions' accuracy is JAX's, sample for
    sample (the phase-2 artifact, GraphONE over its banks)."""
    ours, ref, _ = predict_both(artifacts, "oscc", NOVEL, tmp_path, "val")
    assert {u: o["state_change"] for u, o in ours.items()} == \
        {u: r["state_change"] for u, r in ref.items()}


def test_ar_has_no_writer_and_resume_is_required(artifacts):
    root, tmp = artifacts
    with pytest.raises(ValueError, match="no prediction writer"):
        tpredict.main(base(root, tmp, "device=cpu", "task=ar"))
    with pytest.raises(ValueError, match="resume_from"):
        tpredict.main(base(root, tmp, "device=cpu", "task=oscc",
                           "validation_split=test_unannotated"))


def test_cli_writes_predictions(artifacts, tmp_path):
    root, tmp = artifacts
    out = tmp_path / "pnr.json"
    proc = subprocess.run(
        [sys.executable, "-m", "egopack_torch.predict",
         *base(root, tmp, f"resume_from={NOVEL}",
               "validation_split=test_unannotated", "device=cpu"),
         "task=pnr", f"output={out}"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "predicting with ar/lta-bank interaction" in proc.stderr
    assert "Wrote" in proc.stderr and "PNR predictions" in proc.stderr
    preds = json.loads(out.read_text())
    assert len(preds) > 0
    assert all(set(v) == {"pnr_frame"} for v in preds.values())
