"""The port's multi-GPU layer in real ``torch.distributed`` worlds of 2 and
4 gloo ranks on the CPU, each rank a process of its own
(``tests/torch_port_multiproc_worker.py``, started by
``egopack_torch.parallel.launch.run_ranks`` with a free port and a time
limit a world), against the JAX package's mesh on the 8 virtual CPU
devices of ``tests/conftest.py`` from the same weights and batches,
dropout off.

Tolerances: steps, sweeps and drivers rtol 1e-4 / atol 1e-5 (float32 sums
in another order, the tolerance of the one-process port tests); top-k
indices equal and distances within 1e-6; validation accuracies equal."""

import json
import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as ge
import main_temporal as jmain
from egopack_torch import interop
from egopack_torch.data.synthetic import generate_ego4d_fixture
from egopack_torch.parallel.launch import check_ranks, run_ranks
from egopack_tpu.evaluate import main as jevaluate
from egopack_tpu.models.graphone import build_prototypes, make_prototype_step
from egopack_tpu.ops.knn import prototype_topk
from egopack_tpu.parallel import mesh as jmesh
from egopack_tpu.train import optim as jopt
from egopack_tpu.train import system as jsystem
from egopack_tpu.train.driver import trainable_mask_fn as j_mask
from torch_port_common import (FEAT, by_epoch, jax_phase2, jax_system,
                               numpy_banks, records, to_np)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
WORKER = osp.join(REPO, "tests", "torch_port_multiproc_worker.py")
TOL = dict(rtol=1e-4, atol=1e-5)
WORLD_S = 240  # each world's time limit
ACTIVE = ("ar", "lta", "oscc", "pnr")
LR = 1e-3
# the grids and what each runs beside the phase-1 step
GRIDS = {(2, 1): ("proto",), (2, 2): ("proto", "egopack"),
         (1, 2): ("egopack", "topk"), (1, 4): ("topk",)}


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)


def launch(job, in_dir, out_dir, grid, *argv):
    """One world of ``grid`` ranks; started again once if another process
    took its port between ``free_port`` and the rendezvous."""
    for _ in range(2):
        res = run_ranks([sys.executable, WORKER, job, str(in_dir),
                         str(out_dir), str(grid[0]), str(grid[1]), *argv],
                        grid[0] * grid[1], WORLD_S, env=_env(), cwd=REPO)
        if not any("Address already in use" in r.stderr for r in res):
            break
    check_ranks(res, f"{job} on a {grid[0]}x{grid[1]} grid")
    return res


def _flat(batches):
    return {f"{t}/{k}": np.asarray(v) for t, b in batches.items()
            for k, v in b.items()}


def _knn_inputs():
    """Two banks of 128 rows, 32 features, k 8. Bank 0: rows 31/32 and
    63/64 (the shard boundaries of model 4 and 2) hold the same basis
    vector, which some features point along, so the two distances tie
    exactly; rows 64-95 (a model-4 shard) hold 3 valid rows. Bank 1: 5
    valid rows of 128, fewer than k."""
    rng = np.random.default_rng(11)
    bank = rng.normal(size=(2, 128, 32)).astype(np.float32)
    for r in (31, 32):
        bank[0, r] = 0.0
        bank[0, r, 5] = 2.0
    for r in (63, 64):
        bank[0, r] = 0.0
        bank[0, r, 9] = 3.0
    mask = np.ones((2, 128), bool)
    mask[0, 67:96] = False
    mask[1, 5:] = False
    feats = rng.normal(size=(2, 12, 32)).astype(np.float32)
    feats[:, :3] *= 0.01
    feats[:, 0, 5] = feats[:, 3, 5] = 1.0
    feats[:, 1, 9] = feats[:, 4, 9] = 1.0
    return feats, bank, mask, 8


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """Every grid of ``GRIDS`` run once on the same inputs; returns the JAX
    references and each grid's rank-0 results (and rank 1's)."""
    in_dir = tmp_path_factory.mktemp("mp_in")
    jsys, jparams = jax_system()
    np.savez(in_dir / "phase1.npz",
             **{k: v.numpy()
                for k, v in interop.from_flax(to_np(jparams)).items()})
    jb = to_np(ge._synthetic_batches(jsys, 4, FEAT, seed=3))
    jb["ar"]["valid"][-1] = False  # ranks hold unequal valid shares
    jb["lta"]["valid"][1] = False
    np.savez(in_dir / "batches.npz", **_flat(jb))
    # the prototype sweep's batches (tests/test_multichip.py:413-428)
    rng = np.random.default_rng(0)
    proto = []
    for i in range(3):
        y = np.full((8, 9, 2), -1, np.int32)
        y[:, 4, 0] = rng.integers(0, 6, 8)
        y[:, 4, 1] = rng.integers(0, 4, 8)
        valid = np.ones(8, bool)
        if i == 2:
            valid[5:] = False
        proto.append({"x": rng.normal(size=(8, 9, 3, FEAT)).astype(
            np.float32), "y": y, "valid": valid})
    np.savez(in_dir / "proto.npz", **{f"{i}/{k}": v for i, b in
                                      enumerate(proto) for k, v in b.items()})
    banks = numpy_banks()
    np.savez(in_dir / "banks.npz", **{f"{t}/{w}": a for t, (v, m) in
                                      banks.items()
                                      for w, a in (("values", v),
                                                   ("mask", m))})
    ego = {}
    for freeze in (True, False):
        tag = "frozen" if freeze else "trained"
        j2 = jax_phase2(banks, k=8, freeze=freeze)
        ego[tag] = j2
        np.savez(in_dir / f"phase2_{tag}.npz",
                 **{k: v.numpy() for k, v in
                    interop.from_flax(to_np(j2[2])).items()})
    feats, bank, mask, k = _knn_inputs()
    np.savez(in_dir / "knn.npz", features=feats, bank=bank, mask=mask,
             k=np.int64(k))

    out = {"jsys": jsys, "jparams": jparams, "jb": jb, "proto": proto,
           "ego": ego, "banks": banks}
    for grid, jobs in GRIDS.items():
        impl = "fused" if grid == (1, 2) else "optax"
        with open(in_dir / "steps.json", "w") as f:
            json.dump({"impl": impl, "jobs": list(jobs)}, f)
        out_dir = tmp_path_factory.mktemp("mp_out")
        launch("steps", in_dir, out_dir, grid)
        ranks = []
        for r in range(grid[0] * grid[1]):
            with np.load(out_dir / f"rank{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        out[grid] = (impl, ranks)
    return out


def _jax_step(g, grid, impl):
    mesh = jmesh.make_mesh(*grid)
    params = jmesh.place_params(
        jax.tree_util.tree_map(jnp.array, g["jparams"]), mesh)
    opt = jopt.adam(LR, 0.01, impl=impl)
    state = jopt.init_opt_state(opt, params, mesh)
    step = g["jsys"].make_train_step(opt, ACTIVE)
    batches = {n: jmesh.shard_batch({k: jnp.asarray(v) for k, v in b.items()},
                                    mesh) for n, b in g["jb"].items()}
    new, _, logs = step(params, state, batches, jax.random.PRNGKey(7), LR)
    return interop.from_flax(to_np(new)), {k: float(v)
                                           for k, v in logs.items()}


def _check_step(ours, ref_params, ref_logs, prefix="step"):
    logs = {k.split("/", 2)[2]: v for k, v in ours.items()
            if k.startswith(f"{prefix}/log/")}
    assert set(logs) == set(ref_logs)
    for k, v in ref_logs.items():
        np.testing.assert_allclose(logs[k], v, err_msg=k, **TOL)
    params = {k.split("/", 2)[2]: v for k, v in ours.items()
              if k.startswith(f"{prefix}/param/")}
    assert set(params) == set(ref_params)
    for k, v in ref_params.items():
        np.testing.assert_allclose(params[k], v.numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)])
def test_dp_matches_single_device(grids, grid):
    """One phase-1 step over all four tasks with data parallelism (and the
    pooling MLP split over 2), samples invalid on some ranks only, against
    the JAX step on the same mesh: losses, norms and every updated
    parameter, on every rank."""
    impl, ranks = grids[grid]
    ref_params, ref_logs = _jax_step(grids, grid, impl)
    for ours in ranks:
        _check_step(ours, ref_params, ref_logs)


def test_fused_adam_on_tp_mesh_matches_optax(grids):
    """The pooling MLP split over 2 ranks with the fused Adam on each
    rank's shards, against the JAX mesh (1, 2), where the fused Adam runs
    its jnp path (egopack_tpu/train/optim.py:200-212)."""
    impl, ranks = grids[(1, 2)]
    assert impl == "fused"
    ref_params, ref_logs = _jax_step(grids, (1, 2), impl)
    for ours in ranks:
        _check_step(ours, ref_params, ref_logs)


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)])
def test_sharded_prototype_build_matches_single_device(grids, grid):
    """The prototype sweep split over the data axis (padded tail rows
    included) gives the single-device JAX banks on every rank."""
    system, params = grids["jsys"], grids["jparams"]
    step = make_prototype_step(system, ("lta", "pnr"), 6, 4)
    ref = build_prototypes(step, params, grids["proto"], 6, 4, n_tasks=2)
    for ours in grids[grid][1]:
        for t, b in ref.items():
            np.testing.assert_array_equal(ours[f"proto/{t}/mask"],
                                          np.asarray(b.mask))
            np.testing.assert_allclose(ours[f"proto/{t}/values"],
                                       np.asarray(b.values), err_msg=t,
                                       **TOL)


@pytest.mark.parametrize("grid", [(1, 2), (1, 4)])
def test_sharded_bank_topk_matches_replicated(grids, grid):
    """The k nearest over banks split by row over 2 and 4 ranks, with a
    tie across a shard boundary, a shard of fewer than k valid rows and a
    bank of fewer than k valid rows: JAX's replicated ``prototype_topk``
    (``xla``), indices equal, distances within 1e-6."""
    feats, bank, mask, k = _knn_inputs()
    for ours in grids[grid][1]:
        for t in range(2):
            idx, dist = prototype_topk(jnp.asarray(feats[t]),
                                       jnp.asarray(bank[t]),
                                       jnp.asarray(mask[t]), k, "cosine",
                                       impl="xla")
            np.testing.assert_array_equal(ours["knn/idx"][t],
                                          np.asarray(idx))
            np.testing.assert_allclose(ours["knn/dist"][t],
                                       np.asarray(dist), rtol=0, atol=1e-6)
    # the ties: rows 31 and 32, 63 and 64, in index order
    idx = grids[grid][1][0]["knn/idx"][0]
    assert idx[0, :2].tolist() == [31, 32] and idx[1, :2].tolist() == [63, 64]


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
@pytest.mark.parametrize("tag", ["frozen", "trained"])
def test_egopack_step_sharded_banks_matches_replicated(grids, grid, tag):
    """One phase-2 step on banks split by row over the model axis (and
    with freeze=False the trained bank values split with them, their
    gradients on the ranks that hold their rows) against the JAX step
    with replicated banks."""
    jsys, jgo, params, jbanks = grids["ego"][tag]
    params = jax.tree_util.tree_map(jnp.array, params)  # the step donates
    trainable = ["temporal_graph", "task/oscc", "graphone"]
    if tag == "trained":
        trainable.append("graphone_banks")
    opt = jopt.adam(LR, 0.0, trainable_mask=j_mask(trainable))
    step = jsys.make_egopack_train_step(opt, ("oscc",), jgo)
    batch = {k: jnp.asarray(v) for k, v in grids["jb"]["oscc"].items()}
    new, _, logs = step(params, opt.init(params), jbanks, {"oscc": batch},
                        jax.random.PRNGKey(3), LR)
    ref = interop.from_flax(to_np(new))
    for ours in grids[grid][1]:
        np.testing.assert_allclose(ours[f"{tag}/loss"],
                                   float(logs["oscc_loss"]), **TOL)
        got = {k.split("/", 2)[2]: v for k, v in ours.items()
               if k.startswith(f"{tag}/param/")}
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v.numpy(), err_msg=k, **TOL)
    if tag == "trained":  # the trained banks moved
        moved = [t for t in ("ar", "lta", "pnr") if not np.array_equal(
            ref[f"graphone_banks.{t}"].numpy(), grids["banks"][t][0])]
        assert moved


# ---- the CLIs ----

def _overrides(root, tmp, *extra):
    """tests/test_torch_port_driver.py's phase-1 overrides, dropout off."""
    return ["seed=1", "k=1", "num_epochs=2", "batch_size=4", "num_workers=0",
            "model.hidden_size=32", "model.temporal_pooling.hidden_size=32",
            "oscc_feat_size=32", "model.temporal_pooling.dropout=0",
            "model.depth=2", "save_model=True",
            f"dataset_recognition.root={root}", f"dataset_oscc.root={root}",
            f"dataset_lta.root={root}", f"dataset_pnr.root={root}",
            "validation_split=val", f"artifact_dir={tmp}/artifacts",
            f"output_dir={tmp}/outputs", "enabled_tasks=[ar,lta,pnr]",
            *extra]


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """JAX's one-process phase-1 CLI, and the port's on 2 ranks with
    data 2 and with model 2, from JAX's initial parameters."""
    root = str(tmp_path_factory.mktemp("ego4d"))
    generate_ego4d_fixture(root, feature_dim=16, seed=2)
    tmp = {k: tmp_path_factory.mktemp(k) for k in ("jax", "dp2", "tp2",
                                                    "init")}
    init = {}
    orig = jsystem.MultiTaskSystem.init_params

    def capture(self, rng, feat_dim):
        params = orig(self, rng, feat_dim)
        init["params"] = to_np(params)
        return params

    mp = pytest.MonkeyPatch()
    mp.setattr(jsystem.MultiTaskSystem, "init_params", capture)
    try:
        jres = jmain.main(_overrides(root, tmp["jax"], "parallel.data=1",
                                     "parallel.model=1"))
    finally:
        mp.undo()
    np.savez(tmp["init"] / "init.npz",
             **{k: v.numpy()
                for k, v in interop.from_flax(init["params"]).items()})
    ours = {}
    for name, grid in (("dp2", (2, 1)), ("tp2", (1, 2))):
        launch("driver", tmp["init"], tmp[name], grid,
               *_overrides(root, tmp[name], "device=cpu",
                           f"parallel.data={grid[0]}",
                           f"parallel.model={grid[1]}"))
        ours[name] = str(tmp[name])
    return {"root": root, "jres": jres, "ours": ours, "tmp": tmp}


def _run_dirs(base):
    out = osp.join(base, "outputs")
    return [osp.join(out, d) for d in sorted(os.listdir(out))]


@pytest.mark.parametrize("name", ["dp2", "tp2"])
def test_two_rank_driver_matches_jax(drivers, name):
    """The port's phase-1 CLI on 2 gloo ranks (rank 0 alone writes a run
    directory) against JAX's one-process CLI on the same fixture from the
    same initial parameters: train records rtol 1e-4, validation accuracies
    equal and losses rtol 1e-4 (tests/test_multihost.py:105-178); LTA's
    edit distances, which rest on samples, in range."""
    dirs = _run_dirs(drivers["ours"][name])
    assert len(dirs) == 1
    ours, ref = records(dirs[0]), records(drivers["jres"]["run_dir"])
    for prefix in ("train/", "val/"):
        a, b = by_epoch(ours, prefix), by_epoch(ref, prefix)
        assert sorted(a) == sorted(b) == [1, 2]
        for epoch in b:
            assert set(a[epoch]) == set(b[epoch])
            for k, v in b[epoch].items():
                what = f"{name} epoch {epoch} {k}"
                if k.startswith("val/lta/") and k.endswith("_ed"):
                    assert 0.0 <= a[epoch][k] <= 1.0, what
                elif prefix == "train/" or k.endswith(
                        ("loss", "calibration_error", "brier_score",
                         "auroc", "localization_error")):
                    np.testing.assert_allclose(a[epoch][k], v, rtol=1e-4,
                                               err_msg=what)
                else:
                    assert a[epoch][k] == v, what


def test_cold_eval_on_mesh_matches_single_device(drivers):
    """The artifact of the model-2 run, evaluated cold by the port on 2
    ranks with model 2 and by JAX on one device: the same metrics (AR and
    PNR accuracies equal, losses rtol 1e-5); and it holds whole tensors
    that JAX reads."""
    tmp, root = drivers["tmp"]["tp2"], drivers["root"]
    common = _overrides(root, tmp, "resume_from=MTL_ar-lta-pnr")
    out = tmp / "metrics.json"
    launch("evaluate", tmp, tmp, (1, 2), *common, "device=cpu",
           "parallel.data=1", "parallel.model=2", f"output={out}")
    with open(out) as f:
        ours = json.load(f)
    ref = jevaluate(common + ["parallel.data=1", "parallel.model=1"])
    assert set(ours) == set(ref) == {"ar", "lta", "pnr"}
    for task in ("ar", "pnr"):
        for k, v in ref[task].items():
            if k.endswith(("loss", "calibration_error", "brier_score",
                           "auroc", "localization_error")):
                np.testing.assert_allclose(ours[task][k], v, rtol=1e-5,
                                           err_msg=f"{task} {k}")
            else:
                assert ours[task][k] == v, (task, k)
    np.testing.assert_allclose(ours["lta"]["loss"], ref["lta"]["loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("nproc", [2, 4])
def test_dryrun(nproc):
    """``python -m egopack_torch.parallel.dryrun --nproc N --device cpu``:
    every rank's three steps report the one-process losses."""
    proc = subprocess.run([sys.executable, "-m",
                           "egopack_torch.parallel.dryrun", "--nproc",
                           str(nproc), "--device", "cpu", "--timeout",
                           str(WORLD_S)],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=2 * WORLD_S + 60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["agree"] and report["nproc"] == nproc
    assert report["mesh"] == ([nproc // 2, 2])
