"""The port's worker-process loader (``WorkerPoolLoader``,
``loader_processes > 0``) against the JAX package's loaders on one seeded
fixture: the pooled stream equals JAX's single-process ``DataLoader`` batch
for batch, bit for bit, under fork and under spawn; the feature gathers the
workers make reach the consumer's counts; and the failure modes of
``tests/test_data.py`` (an abandoned pass, a worker's error, a dead worker,
a stalled worker, close and the finalizer) behave as there."""

import gc
import os
import pickle

import numpy as np
import pytest

from egopack_torch.data import fho as tfho
from egopack_torch.data import loader as tloader
from egopack_torch.data import osccpnr as tosccpnr
from egopack_torch.data.synthetic import generate_ego4d_fixture
from egopack_torch.io import native as tnative
from egopack_tpu.data import fho as jfho
from egopack_tpu.data import loader as jloader
from egopack_tpu.data import osccpnr as josccpnr
from egopack_tpu.io import native as jnative

FIXTURE = dict(feature_dim=16, n_videos=2, actions_per_clip=30, n_oscc=24,
               seed=3, learnable=True)
DATASETS = {
    "ar": (tfho.Ego4dRecognitionDataset, jfho.Ego4dRecognitionDataset,
           dict(num_segments=3)),
    "lta": (tfho.Ego4dLTADataset, jfho.Ego4dLTADataset, dict(num_segments=3)),
    "oscc": (tosccpnr.Ego4dOSCCDataset, josccpnr.Ego4dOSCCDataset,
             dict(num_segments=3, aug_prob=0.5)),
    "pnr": (tosccpnr.Ego4dPNRDataset, josccpnr.Ego4dPNRDataset,
            dict(num_segments=16)),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_ego4d_fixture(str(tmp_path_factory.mktemp("pool")),
                                  **FIXTURE)


@pytest.fixture(autouse=True)
def jax_numpy_gather(monkeypatch):
    """JAX gathers with its numpy path, which the port's native path
    equals bit for bit (see tests/test_torch_port_data.py)."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


def datasets(root, task, split="train"):
    tcls, jcls, kw = DATASETS[task]
    return tcls(split, root=root, **kw), jcls(split, root=root, **kw)


def assert_streams_equal(ours, ref, what):
    assert len(ours) == len(ref) > 0, what
    for k, (a, b) in enumerate(zip(ours, ref)):
        assert set(a) == set(b), (what, k)
        for key in b:
            if isinstance(b[key], np.ndarray):
                assert a[key].dtype == b[key].dtype, (what, k, key)
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{what} {k} {key}")
            else:
                assert a[key] == b[key], (what, k, key)


def epochs_of(loader, epochs=(1, 2), passes=2):
    """Every batch of ``passes`` passes (the second is a multiloader
    wraparound's reshuffle) of each epoch."""
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        for _ in range(passes):
            out.extend(dict(b) for b in loader)
    return out


@pytest.mark.parametrize("task", sorted(DATASETS))
def test_pool_stream_matches_jax(root, task):
    """Two forked workers against JAX's single-process loader: the train
    stream (shuffled, drop_last, augmentations on) over two epochs of two
    passes, and the val stream (its padded last batch)."""
    ours, ref = datasets(root, task)
    pool = tloader.build_dataloader(ours, 4, True, 0, True, seed=7,
                                    worker_processes=2)
    assert isinstance(pool, tloader.WorkerPoolLoader)
    try:
        jl = jloader.DataLoader(ref, 4, True, True, seed=7, prefetch=0)
        assert_streams_equal(epochs_of(pool), epochs_of(jl), f"{task} train")
    finally:
        pool.close()
    ours, ref = datasets(root, task, "val")
    pool = tloader.build_dataloader(ours, 5, False, 0, False, seed=7,
                                    worker_processes=2)
    try:
        jl = jloader.DataLoader(ref, 5, False, False, seed=7, prefetch=0)
        assert_streams_equal(epochs_of(pool, (1,), 1), epochs_of(jl, (1,), 1),
                             f"{task} val")
    finally:
        pool.close()


def test_pool_stream_matches_jax_under_spawn(root, monkeypatch):
    """``EGOPACK_POOL_CTX=spawn``: the workers unpickle the dataset, whose
    feature store reopens its memmaps by path, and stream the same batches
    as JAX."""
    monkeypatch.setenv("EGOPACK_POOL_CTX", "spawn")
    ours, ref = datasets(root, "oscc")
    pool = tloader.build_dataloader(ours, 4, True, 0, True, seed=7,
                                    worker_processes=2)
    try:
        jl = jloader.DataLoader(ref, 4, True, True, seed=7, prefetch=0)
        assert_streams_equal(epochs_of(pool, (1,)), epochs_of(jl, (1,)),
                             "spawn")
        assert pool._ctx.get_start_method() == "spawn"
    finally:
        pool.close()


def test_feature_store_pickles_paths_not_arrays(root):
    """A spawned worker gets the store's file paths, not a copy of every
    video: the pickle is far smaller than the features, and the copy reads
    the same memmapped arrays."""
    ds = tosccpnr.Ego4dOSCCDataset("train", root=root, num_segments=3)
    store = ds._store
    nbytes = sum(store[u].nbytes for u in store.video_uids)
    blob = pickle.dumps(store)
    assert len(blob) < nbytes / 4
    copy = pickle.loads(blob)
    for uid in store.video_uids:
        assert isinstance(copy[uid], np.memmap)
        np.testing.assert_array_equal(copy[uid], store[uid])


def test_pool_gathers_reach_the_consumer(root):
    """The workers' native gathers are added to the consumer's
    ``PATH_CALLS``: a pooled pass counts what a single-process pass does."""
    ds = tfho.Ego4dRecognitionDataset("train", root=root, num_segments=3)
    single = tloader.build_dataloader(ds, 4, True, 0, True, seed=5)
    pool = tloader.build_dataloader(ds, 4, True, 0, True, seed=5,
                                    worker_processes=2)
    try:
        counts = []
        for loader in (single, pool):
            before = dict(tnative.PATH_CALLS)
            list(loader)
            counts.append({k: tnative.PATH_CALLS[k] - before[k]
                           for k in before})
        assert counts[0] == counts[1]
        assert sum(counts[0].values()) > 0
    finally:
        pool.close()


def test_pool_abandoned_pass_recovers(root):
    """A multiloader wraparound abandons an iterator mid-pass; the next
    pass drops the stale generation and streams exactly."""
    ours, ref = datasets(root, "oscc")
    pool = tloader.build_dataloader(ours, 4, True, 0, True, seed=5,
                                    worker_processes=2)
    jl = jloader.DataLoader(ref, 4, True, True, seed=5, prefetch=0)
    try:
        pool.set_epoch(1)
        jl.set_epoch(1)
        next(iter(pool))  # one batch of pass 0, the rest abandoned
        next(iter(jl))
        assert_streams_equal([dict(b) for b in pool], [dict(b) for b in jl],
                             "pass 1")
    finally:
        pool.close()


class _ExplodingDataset:
    """Every ``get`` raises: the worker reports the error."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def get(self, idx, rng):
        raise ValueError("synthetic get failure")


class _ExitingDataset(_ExplodingDataset):
    """``get`` ends the worker with no error to report."""

    def get(self, idx, rng):
        os._exit(13)


class _SilentDataset(_ExplodingDataset):
    """``get`` blocks: the worker is alive and sends nothing."""

    def get(self, idx, rng):
        import time
        time.sleep(60)


def _pool(root, wrapper):
    ds = tosccpnr.Ego4dOSCCDataset("train", root=root, num_segments=3)
    return tloader.build_dataloader(wrapper(ds), 4, True, 0, True, seed=5,
                                    worker_processes=2)


def test_pool_worker_error_raises_in_the_consumer(root):
    pool = _pool(root, _ExplodingDataset)
    try:
        with pytest.raises(RuntimeError, match="synthetic get failure"):
            next(iter(pool))
    finally:
        pool.close()


def test_pool_dead_worker_raises(root):
    pool = _pool(root, _ExitingDataset)
    pool.GET_TIMEOUT_S = 0.2
    try:
        with pytest.raises(RuntimeError, match="died"):
            next(iter(pool))
    finally:
        pool.close()


def test_pool_stalled_worker_raises(root, monkeypatch):
    monkeypatch.setenv("EGOPACK_POOL_STALL_S", "1")
    pool = _pool(root, _SilentDataset)
    pool.GET_TIMEOUT_S = 0.25
    try:
        with pytest.raises(RuntimeError, match="EGOPACK_POOL_STALL_S"):
            next(iter(pool))
    finally:
        pool.close()


def test_pool_close_and_finalizer_reap_workers(root):
    ds = tosccpnr.Ego4dOSCCDataset("train", root=root, num_segments=3)
    pool = tloader.build_dataloader(ds, 4, True, 0, True, seed=5,
                                    worker_processes=2)
    it = iter(pool)
    next(it)
    procs = list(pool._procs)
    assert len(procs) == 2 and all(p.is_alive() for p in procs)
    pool.close()
    assert not any(p.is_alive() for p in procs)
    assert len(list(pool)) == len(pool)  # a closed pool starts again
    pool.close()

    pool2 = tloader.build_dataloader(ds, 4, True, 0, True, seed=5,
                                     worker_processes=2)
    it2 = iter(pool2)
    next(it2)
    procs2 = list(pool2._procs)
    del pool2, it2
    gc.collect()
    for p in procs2:
        p.join(timeout=10)
    assert not any(p.is_alive() for p in procs2)


def test_close_loaders_stops_every_pool(root):
    ds = tosccpnr.Ego4dOSCCDataset("train", root=root, num_segments=3)
    pools = [tloader.build_dataloader(ds, 4, True, 0, True, seed=5,
                                      worker_processes=1) for _ in range(2)]
    dsets = {"oscc": {"dl_train": pools[0], "dl_val": pools[1]},
             "ar": {"dl_train": tloader.build_dataloader(ds, 4, True, 0,
                                                         True)}}
    procs = []
    for p in pools:
        next(iter(p))
        procs += p._procs
    tloader.close_loaders(dsets)
    assert not any(p.is_alive() for p in procs)
