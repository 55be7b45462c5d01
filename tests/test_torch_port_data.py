"""The port's data layer against the JAX package's, on a small fixture
(feature_dim 16): the fixture files byte for byte, every sample of the four
datasets (train and val) under the same rng, the loader and multiloader
streams over two epochs with the wraparound, and the native gather against
its numpy twin. All exactly."""

import os

import numpy as np
import pytest
import torch

from egopack_torch.data import fho as tfho
from egopack_torch.data import loader as tloader
from egopack_torch.data import osccpnr as tosccpnr
from egopack_torch.data.synthetic import generate_ego4d_fixture
from egopack_torch.io import native as tnative
from egopack_tpu.data import fho as jfho
from egopack_tpu.data import loader as jloader
from egopack_tpu.data import osccpnr as josccpnr
from egopack_tpu.data.synthetic import generate_ego4d_fixture as jgenerate
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


def tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    ours = str(tmp_path_factory.mktemp("ours"))
    ref = str(tmp_path_factory.mktemp("ref"))
    generate_ego4d_fixture(ours, **FIXTURE)
    jgenerate(ref, **FIXTURE)
    return ours, ref, tree_files(ours), tree_files(ref)


@pytest.fixture(autouse=True)
def jax_numpy_gather(monkeypatch):
    """The JAX side gathers with its numpy path: its prebuilt library may
    contract the interpolation to FMA; the port's library does not, so the
    port's native path equals this numpy path bit for bit."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


def test_fixture_files_are_byte_identical(roots):
    _, _, ours, ref = roots
    assert sorted(ours) == sorted(ref)
    for name in ref:
        assert ours[name] == ref[name], name


def assert_sample_equal(a, b, what):
    assert set(a) == set(b), what
    for k in b:
        if isinstance(b[k], np.ndarray) or isinstance(b[k], np.generic):
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (what, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
        else:
            assert a[k] == b[k], (what, k)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("task", sorted(DATASETS))
def test_every_sample_matches_jax(roots, task, split):
    root = roots[0]
    tcls, jcls, kw = DATASETS[task]
    ours, ref = tcls(split, root=root, **kw), jcls(split, root=root, **kw)
    assert len(ours) == len(ref) > 0
    assert ours.num_class_labels == ref.num_class_labels
    spec, jspec = ours.graph_spec(1.0), ref.graph_spec(1.0)
    np.testing.assert_array_equal(spec.adjacency, jspec.adjacency)
    assert spec.num_nodes == jspec.num_nodes
    for i in range(len(ref)):
        for seed in (None, i):
            rng_a = None if seed is None else np.random.default_rng(seed)
            rng_b = None if seed is None else np.random.default_rng(seed)
            assert_sample_equal(ours.get(i, rng_a), ref.get(i, rng_b),
                                f"{task} {split} {i} rng {seed}")


def assert_batches_equal(ours, ref, what):
    assert len(ours) == len(ref), what
    for k, (a, b) in enumerate(zip(ours, ref)):
        if b is None:
            assert a is None
            continue
        assert_sample_equal(a, b, f"{what} batch {k}")


def test_dataloader_streams_match_jax(roots):
    root = roots[0]
    tcls, jcls, kw = DATASETS["ar"]
    ours, ref = tcls("train", root=root, **kw), jcls("train", root=root, **kw)
    for shuffle, drop_last in ((True, True), (False, False)):
        tl = tloader.DataLoader(ours, 7, shuffle, drop_last, seed=5,
                                prefetch=2)
        jl = jloader.DataLoader(ref, 7, shuffle, drop_last, seed=5,
                                prefetch=0)
        assert len(tl) == len(jl)
        for epoch in (1, 2):
            tl.set_epoch(epoch)
            jl.set_epoch(epoch)
            for _ in range(2):  # a second pass: the wraparound's reshuffle
                assert_batches_equal(list(tl), list(jl),
                                     f"shuffle {shuffle} epoch {epoch}")


def test_multiloader_streams_match_jax(roots):
    root = roots[0]
    loaders = {}
    for side in (0, 1):
        mod = (tloader, jloader)[side]
        dls = []
        for task in ("ar", "oscc", "lta", "pnr"):
            cls, kw = DATASETS[task][side], DATASETS[task][2]
            dls.append(mod.DataLoader(cls("train", root=root, **kw), 4, True,
                                      True, seed=1, prefetch=0))
        loaders[side] = dls
    weights = [1, 0, 1, 1]
    tml = tloader.MultiLoader(loaders[0], weights)
    jml = jloader.MultiLoader(loaders[1], weights)
    assert len(tml) == len(jml)
    lens = [len(dl) for dl in loaders[1]]
    assert min(l for l, w in zip(lens, weights) if w) < len(jml)  # wraps
    for epoch in (1, 2):
        for a, b in zip(loaders[0], loaders[1]):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
        ours, ref = list(tml), list(jml)
        assert len(ours) == len(ref) == len(jml)
        for step, (ta, ja) in enumerate(zip(ours, ref)):
            assert_batches_equal(ta, ja, f"epoch {epoch} step {step}")


def test_build_dataloader_refuses_worker_processes(roots):
    ds = DATASETS["ar"][0]("val", root=roots[0], num_segments=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloader.build_dataloader(ds, 4, False, 0, False, worker_processes=2)


def test_native_gather_matches_numpy(monkeypatch):
    if tnative.get_lib() is None:
        pytest.skip("no g++ to build the native gather")
    rng = np.random.default_rng(0)
    src = rng.normal(size=(200, 48)).astype(np.float32)
    idx = np.array([0, 5, 199, 250, -1, 3] + list(rng.integers(0, 200, 60)))
    lo = rng.integers(-2, 202, size=64)
    hi = np.clip(lo + rng.integers(0, 2, size=64), 0, 199)
    frac = rng.random(64).astype(np.float32)
    calls = dict(tnative.PATH_CALLS)
    native = [tnative.gather_rows(src, idx), tnative.gather_interp(src, lo, hi,
                                                                   frac),
              tnative.gather_rows(src, idx, n_threads=4)]
    assert tnative.PATH_CALLS["native"] == calls["native"] + 3
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    plain = [tnative.gather_rows(src, idx), tnative.gather_interp(src, lo, hi,
                                                                  frac),
             tnative.gather_rows(src, idx)]
    assert tnative.PATH_CALLS["numpy"] == calls["numpy"] + 3
    for a, b in zip(native, plain):
        np.testing.assert_array_equal(a, b)
    assert not plain[0][4].any()  # negative index: zero row


def test_device_copies_keep_what_the_steps_read(roots):
    ds = DATASETS["pnr"][0]("val", root=roots[0], num_segments=16)
    batch = tloader.collate([ds.get(i) for i in range(3)], pad_to=4)
    dev = tloader.device_batch(batch, torch.device("cpu"))
    assert set(dev) == {"x", "y", "valid"}
    for k in dev:
        np.testing.assert_array_equal(dev[k].numpy(), batch[k])
    assert dev["valid"].tolist() == [True, True, True, False]
