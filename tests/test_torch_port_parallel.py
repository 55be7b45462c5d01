"""The single-process pieces of the port's multi-GPU layer
(``egopack_torch/parallel``) against the JAX package's mesh on the 8 virtual
CPU devices of ``tests/conftest.py``: the rank grid and its guards, which
parameters split over the model axis, process-sharded loaders, and the
meters' state, its npz exchange and its merge.

Tolerances: none. The grid, the splits and the loader blocks are equal;
merged meters give the one-meter values of both packages exactly."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from egopack_torch import interop
from egopack_torch.data.loader import WorkerPoolLoader
from egopack_torch.data.loader import build_dataloader as tbuild
from egopack_torch.eval import meters as tmeters
from egopack_torch.parallel import mesh as tmesh
from egopack_torch.parallel import multihost as tmh
from egopack_torch.predict import main as tpredict
from egopack_tpu.config import compose, default_config_dir, instantiate
from egopack_tpu.data.loader import build_dataloader as jbuild
from egopack_tpu.eval import meters as jmeters
from egopack_tpu.parallel import mesh as jmesh
from torch_port_common import jax_system, to_np, torch_system

torch.set_num_threads(1)


def test_mesh_shapes():
    """One process is a 1x1 grid; the rank arithmetic of a larger grid
    places rank r at (r // model, r % model), the JAX mesh's device
    layout."""
    one = tmesh.make_mesh()
    assert one.shape == dict(jmesh.make_mesh(1, 1).shape) == {"data": 1,
                                                             "model": 1}
    assert (one.data_index, one.model_index) == (0, 0)
    jm = jmesh.make_mesh(4, 2)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        m = tmesh.Mesh(4, 2, r)
        assert ids[m.data_index, m.model_index] == r
    # the grid holds every process: a grid larger than the world raises
    with pytest.raises(ValueError, match="number of processes"):
        tmesh.make_mesh(2, 1)
    with pytest.raises(ValueError, match="number of processes"):
        tmesh.make_mesh(1, 2)


def test_batch_divisibility_guard():
    """The same SystemExit text as the JAX guard (mesh.py:48-56)."""
    grid = tmesh.Mesh(2, 1)
    tmesh.check_batch_divisible(4, grid)
    jm = jmesh.make_mesh(2, 1)
    with pytest.raises(SystemExit) as ours:
        tmesh.check_batch_divisible(5, grid)
    with pytest.raises(SystemExit) as ref:
        jmesh.check_batch_divisible(5, jm)
    assert str(ours.value) == str(ref.value)
    assert "not divisible by parallel.data=2" in str(ours.value)


@pytest.mark.parametrize("model", [2, 4, 3])
def test_param_shardings_match_jax(model):
    """Each parameter splits over the model axis where, and along the
    dimension that, the JAX mesh's ``_param_spec`` splits its flax leaf
    (fc0 kernel and bias by output, fc1 kernel by input; nothing at a
    width the axis does not divide)."""
    jsys, jparams = jax_system()
    ours = torch_system(jparams).params()
    jm = jmesh.make_mesh(8 // model, model)
    flat = {"/".join(getattr(k, "key", str(k)) for k in kp): leaf
            for kp, leaf in jax.tree_util.tree_flatten_with_path(
                to_np(jparams))[0]}
    split = 0
    for name, p in ours.items():
        path = "/".join(interop.flax_path(name, p.ndim))
        spec = jmesh._param_spec(path, flat[path], jm)
        want = {P(): None, P(None, "model"): 0, P("model", None): 1,
                P("model"): 0}[spec]
        got = tmesh.param_spec(name, tuple(p.shape), model)
        assert got == want, (name, spec, got)
        split += got is not None
    assert split == (3 if model in (2, 4) else 0)


def test_place_params_keeps_this_ranks_slices():
    """Each rank of a model row keeps its slice of the split leaves, and
    the slices put together are the whole leaf."""
    _, jparams = jax_system()
    whole = torch_system(jparams).params()
    parts = {}
    for index in range(2):
        system = torch_system(jparams)
        grid = tmesh.Mesh(1, 2, index,
                          model_axis=tmesh.Axis(None, 2, index))
        tmesh.place_params(system, grid)
        assert system.backbone.pooling.model_axis.size == 2
        parts[index] = system.params()
        assert set(system.shards) == {"temporal_graph.pooling.fc0.weight",
                                      "temporal_graph.pooling.fc0.bias",
                                      "temporal_graph.pooling.fc1.weight"}
    for name, dim in system.shards.items():
        assert torch.equal(torch.cat([parts[0][name], parts[1][name]], dim),
                           whole[name]), name
    for name in whole:
        if name not in system.shards:
            assert torch.equal(parts[1][name], whole[name]), name


def _loader_cfg(root):
    return compose(default_config_dir(), "defaults",
                   overrides=[f"dataset_recognition.root={root}"])


@pytest.mark.parametrize("pool", [0, 2])
def test_loader_process_sharding_reassembles(ego4d_root, pool):
    """Two process-sharded loaders (in-process, and with 2 worker
    processes each) put back together are the unsharded loader's global
    batches, and each block is the JAX package's sharded loader's
    (tests/test_multihost.py:43-68)."""
    ds = instantiate(_loader_cfg(ego4d_root).dataset_recognition,
                     split="train")
    full = tbuild(ds, 8, True, 0, True, seed=3)
    shards = [tbuild(ds, 8, True, 0, True, seed=3, worker_processes=pool,
                     process_shard=(p, 2)) for p in range(2)]
    jshards = [jbuild(ds, 8, True, 0, True, seed=3, process_shard=(p, 2))
               for p in range(2)]
    try:
        for dl in [full] + shards + jshards:
            dl.set_epoch(1)
        if pool:
            assert all(isinstance(s, WorkerPoolLoader)
                       and s.process_shard == (i, 2)
                       for i, s in enumerate(shards))
        fb = list(full)
        sb = [list(s) for s in shards]
        jb = [list(s) for s in jshards]
        assert fb and len(fb) == len(sb[0]) == len(sb[1]) == len(jb[0])
        for k, batch in enumerate(fb):
            for key in ("x", "y", "valid"):
                np.testing.assert_array_equal(
                    batch[key], np.concatenate([sb[0][k][key],
                                                sb[1][k][key]]))
                for p in range(2):
                    np.testing.assert_array_equal(sb[p][k][key],
                                                  jb[p][k][key])
    finally:
        for s in shards:
            if hasattr(s, "close"):
                s.close()


class _RngSensitiveDS:
    """Samples that depend on the augmentation rng
    (tests/test_multihost.py:71-82)."""

    def __len__(self):
        return 37

    def get(self, idx, rng=None):
        jitter = (rng.standard_normal(4).astype(np.float32)
                  if rng is not None else np.zeros(4, np.float32))
        return {"x": np.full(4, idx, np.float32) + jitter, "y": np.int32(idx)}


def test_loader_sharding_reassembles_rng_dependent_augmentation():
    """The augmentation rng is keyed by the global sample index, so the
    shards draw the unsharded loader's jitter, and a short last batch
    leaves the shard without samples a batch of filler."""
    ds = _RngSensitiveDS()
    full = tbuild(ds, 8, True, 0, False, seed=5)
    shards = [tbuild(ds, 8, True, 0, False, seed=5, process_shard=(p, 4))
              for p in range(4)]
    jshards = [jbuild(ds, 8, True, 0, False, seed=5, process_shard=(p, 4))
               for p in range(4)]
    for dl in [full] + shards + jshards:
        dl.set_epoch(2)
    fb = list(full)
    sb = [list(s) for s in shards]
    jb = [list(s) for s in jshards]
    assert len(fb) == 5 and all(len(s) == 5 for s in sb)
    for k, batch in enumerate(fb):
        cat = np.concatenate([sb[p][k]["x"] for p in range(4)])
        valid = np.concatenate([sb[p][k]["valid"] for p in range(4)])
        np.testing.assert_array_equal(valid, batch["valid"])
        np.testing.assert_array_equal(cat[valid], batch["x"][valid])
        for p in range(4):
            np.testing.assert_array_equal(sb[p][k]["x"], jb[p][k]["x"])
            np.testing.assert_array_equal(sb[p][k]["valid"],
                                          jb[p][k]["valid"])
    # 37 samples: the last batch holds 5, so the last two blocks of 2 hold
    # one sample and none
    assert sb[2][-1]["valid"].tolist() == [True, False]
    assert not sb[3][-1]["valid"].any()


# ---- meters: state, npz exchange, merge ----

_DS = SimpleNamespace(num_class_labels=(5, 7),
                      class_labels=([f"v{i}" for i in range(5)],
                                    [f"n{i}" for i in range(7)]))
_ROWS = (4, 4, 3)  # valid rows of three global batches of 4


def _updates(kind, rng):
    """One meter's ``update`` arguments per global batch, for its valid
    rows, and the global per-batch loss."""
    out = []
    for n in _ROWS:
        loss = float(rng.uniform(0.1, 2.0))
        if kind == "oscc":
            out.append(((rng.normal(size=(n, 2)).astype(np.float32),
                         rng.integers(0, 2, n)), {}, loss))
        elif kind == "ar":
            out.append((((rng.normal(size=(n, 5)).astype(np.float32),
                          rng.normal(size=(n, 7)).astype(np.float32)),
                         np.stack([rng.integers(0, 5, n),
                                   rng.integers(0, 7, n)], 1)), {}, loss))
        elif kind == "pnr":
            start = rng.integers(0, 100, n).astype(np.float32)
            out.append(((rng.normal(size=(n, 16)),
                         (rng.uniform(size=(n, 16)) > 0.8).astype(np.int32)),
                        {"start_frame": start, "end_frame": start + 240,
                         "pnr_frame": start + rng.integers(0, 240, n)},
                        loss))
        else:  # lta: 22 nodes a sample, K=5 sequences
            m = n * 22
            labels = np.stack([rng.integers(-1, 5, m),
                               rng.integers(-1, 7, m)], 1)
            out.append((((rng.normal(size=(m, 5)).astype(np.float32),
                          rng.normal(size=(m, 7)).astype(np.float32)),
                         labels, (rng.integers(0, 5, (m, 5)),
                                  rng.integers(0, 7, (m, 5)))), {}, loss))
    return out


def _meter(module, kind):
    return {"oscc": lambda: module.Ego4dOSCCMeter(),
            "ar": lambda: module.Ego4dRecognitionMeter(_DS),
            "pnr": lambda: module.Ego4dPNRMeter(),
            "lta": lambda: module.Ego4dLTAMeter(_DS)}[kind]()


def _block(arg, rows, per, p, node_rows):
    """Rank ``p``'s rows of one update argument (``node_rows`` rows per
    sample)."""
    if isinstance(arg, tuple):
        return tuple(_block(a, rows, per, p, node_rows) for a in arg)
    lo, hi = min(p * per, rows), min((p + 1) * per, rows)
    return arg[lo * node_rows:hi * node_rows]


@pytest.mark.parametrize("kind", ["oscc", "ar", "pnr", "lta"])
def test_meter_state_merge_matches_one_meter(kind):
    """Two ranks' meters over their blocks, exchanged as npz payloads and
    merged, give one meter's values over the whole set exactly, and the
    JAX package's meter's."""
    updates = _updates(kind, np.random.default_rng(7))
    node_rows = 22 if kind == "lta" else 1
    full, ref = _meter(tmeters, kind), _meter(jmeters, kind)
    ranks = [_meter(tmeters, kind) for _ in range(2)]
    for (args, kw, loss), rows in zip(updates, _ROWS):
        full.update(*args, loss=loss, **kw)
        ref.update(*args, loss=loss, **kw)
        for p, meter in enumerate(ranks):
            meter.update(*_block(args, rows, 2, p, node_rows), loss=loss,
                         **{k: _block(v, rows, 2, p, 1)
                            for k, v in kw.items()})
    states = [tmh.state_from_bytes(tmh.state_to_bytes(p, m.state()))
              for p, m in enumerate(ranks)]
    assert [pid for pid, _ in states] == [0, 1]
    ranks[0].merge_states([st for _, st in states])
    assert ranks[0].get_logs() == full.get_logs() == ref.get_logs()
    assert ranks[0]._samples == full._samples


def test_meter_state_round_trip_and_merge_state():
    """The npz exchange carries numeric arrays only; ``merge_state``
    appends another meter's accumulators as the JAX meter's does."""
    meter = tmeters.Ego4dOSCCMeter()
    meter.update(np.ones((2, 2), np.float32), np.array([0, 1]), 0.5)
    pid, st = tmh.state_from_bytes(tmh.state_to_bytes(3, meter.state()))
    assert pid == 3 and st["loss_count"] == 1 and st["samples"] == 2
    np.testing.assert_array_equal(st["_labels"][0], [0, 1])
    other = tmeters.Ego4dOSCCMeter()
    other.merge_state(st)
    assert other.get_logs() == meter.get_logs()
    other.merge_state(st, include_loss=False)
    assert other._loss_count == 1 and other._samples == 4
    with pytest.raises(TypeError, match="not numeric"):
        tmh.state_to_bytes(0, {"bad": [object()]})


def test_predict_raises_in_a_world_of_processes(monkeypatch):
    """predict runs in one process, as the JAX package's does; under a
    world of several it names its ROADMAP item."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        tpredict(["resume_from=MTL_x", "task=oscc", "device=cpu"])
