"""The port's artifacts against the JAX package's: the msgpack codec writes
the bytes ``flax.serialization.msgpack_serialize`` writes and reads what
``msgpack_restore`` reads; each package loads the other's artifact leaf for
leaf, bit for bit; a taken name is versioned; the full-state checkpoint
round-trips."""

import json
import os

import numpy as np
import pytest
import torch
from flax import serialization

from egopack_torch import entry as tentry
from egopack_torch import interop
from egopack_torch.device import make_generator
from egopack_torch.train import checkpoint as tckpt
from egopack_torch.train import msgpack_codec
from egopack_torch.train import optim as topt
from egopack_tpu.train import checkpoint as jckpt


def phase1_payload():
    """A phase-1 artifact payload: the flax tree of a small port system
    (float32 leaves), an int32 and a bool leaf, and the 0-d ``epoch``."""
    system = tentry.build_system(8, 8, 4, device="cpu")
    system.init_params(make_generator(0, "cpu"))
    payload = interop.to_flax(system.params())
    payload["extra"] = {"counts": np.arange(6, dtype=np.int32).reshape(2, 3),
                        "mask": np.array([True, False, True])}
    payload["epoch"] = np.asarray(3)
    return payload


def assert_trees_identical(a, b, path="payload"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_trees_identical(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_codec_bytes_equal_flax():
    payload = phase1_payload()
    assert msgpack_codec.packb(payload) == serialization.msgpack_serialize(
        payload)


def test_codec_reads_flax_bytes():
    payload = phase1_payload()
    blob = serialization.msgpack_serialize(payload)
    ours, ref = msgpack_codec.unpackb(blob), serialization.msgpack_restore(blob)
    assert_trees_identical(ours, ref)
    assert_trees_identical(ours, payload)


def test_codec_refuses_what_flax_would_chunk():
    big = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32),
                                          shape=(2 ** 28 + 1,), strides=(0,))
    with pytest.raises(ValueError, match="chunks"):
        msgpack_codec.packb({"big": big})
    with pytest.raises(TypeError):
        msgpack_codec.packb({"t": (1, 2)})


def test_each_package_reads_the_others_artifact(tmp_path):
    payload = phase1_payload()
    meta = {"tasks": ["ar", "lta", "pnr"], "num_epochs": 3}
    tckpt.save_artifact(str(tmp_path / "ours"), "MTL_ar-lta-pnr", payload,
                        meta)
    jckpt.save_artifact(str(tmp_path / "ref"), "MTL_ar-lta-pnr", payload,
                        meta)
    for side in ("ours", "ref"):
        d = str(tmp_path / side)
        for load in (tckpt.load_artifact, jckpt.load_artifact):
            loaded, got_meta = load(d, "entity/project/MTL_ar-lta-pnr:latest")
            assert_trees_identical(loaded, payload)
            assert got_meta == meta
    with open(tmp_path / "ours" / "MTL_ar-lta-pnr" / "checkpoint.msgpack",
              "rb") as f, open(tmp_path / "ref" / "MTL_ar-lta-pnr" /
                               "checkpoint.msgpack", "rb") as g:
        assert f.read() == g.read()
    # the port's system takes the loaded tree back in
    loaded, _ = tckpt.load_artifact(str(tmp_path / "ref"), "MTL_ar-lta-pnr")
    loaded.pop("epoch")
    loaded.pop("extra")
    system = tentry.build_system(8, 8, 4, device="cpu")
    system.load_state(interop.from_flax(loaded))


def test_artifact_versioning(tmp_path):
    d = str(tmp_path)
    for epoch in (1, 2, 3):
        tckpt.save_artifact(d, "MTL_ar", {"epoch": np.asarray(epoch)},
                            {"num_epochs": epoch})
    files = sorted(os.listdir(tmp_path / "MTL_ar"))
    assert files == ["checkpoint.msgpack", "checkpoint_v1.msgpack",
                     "checkpoint_v2.msgpack", "meta.json", "meta_v1.json",
                     "meta_v2.json"]
    loaded, meta = tckpt.load_artifact(d, "MTL_ar")
    assert int(loaded["epoch"]) == 3 and meta == {"num_epochs": 3}
    with open(tmp_path / "MTL_ar" / "meta_v1.json") as f:
        assert json.load(f) == {"num_epochs": 1}


def test_state_round_trip(tmp_path):
    system = tentry.build_system(8, 8, 4, device="cpu")
    system.init_params(make_generator(1, "cpu"))
    opt = topt.adam(1e-3, 1e-5)
    state = opt.init(system.params())
    gen = torch.Generator().manual_seed(7)
    grads = {n: torch.randn(p.shape, generator=gen)
             for n, p in system.params().items()}
    opt.apply(grads, state, system.params())
    d = str(tmp_path / "mtl_MTL_ar")
    assert tckpt.latest_state(d) is None
    saved = {"params": {n: p.detach() for n, p in system.params().items()},
             "mu": state.mu, "nu": state.nu, "count": state.count,
             "generator": gen.get_state(), "epoch": 2}
    tckpt.save_state(d, 2, saved)
    tckpt.save_state(d, 1, saved)
    (tmp_path / "mtl_MTL_ar" / "step_000009.123.tmp").write_bytes(b"partial")
    assert tckpt.latest_state(d) == 2
    back = tckpt.restore_state(d, 2, torch.device("cpu"))
    assert back["count"] == 1 and back["epoch"] == 2
    for key in ("params", "mu", "nu"):
        for n, v in saved[key].items():
            assert torch.equal(back[key][n], v), (key, n)
    g2 = torch.Generator()
    g2.set_state(back["generator"])
    assert torch.equal(torch.rand(4, generator=g2), torch.rand(4, generator=gen))
