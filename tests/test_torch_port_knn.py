"""The port's prototype k-NN (``egopack_torch/ops/knn.py`` and the plain
version of the kernel in ``ops/knn_topk.py``) against
``egopack_tpu.ops.knn.prototype_topk(impl="xla")``: same numpy inputs,
indices exact, distances within 1e-5."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egopack_torch.ops import knn as tknn
from egopack_torch.ops import knn_topk as tkt
from egopack_tpu.ops import knn as jknn
from egopack_tpu.ops.pallas.knn_topk import cosine_knn_pallas

torch.set_num_threads(1)

DIST_ATOL = 1e-5


def _inputs(m, p, f, seed, valid=0.8, t=None):
    rng = np.random.default_rng(seed)
    lead = () if t is None else (t,)
    feats = rng.normal(size=lead + (m, f)).astype(np.float32)
    bank = rng.normal(size=lead + (p, f)).astype(np.float32)
    mask = rng.random(lead + (p,)) < valid
    return feats, bank, mask


def _port(feats, bank, mask, k, **kw):
    idx, dist = tknn.prototype_topk(torch.from_numpy(feats),
                                    torch.from_numpy(bank),
                                    torch.from_numpy(mask), k, **kw)
    return idx.numpy(), dist.numpy()


def _xla(feats, bank, mask, k, distance="cosine"):
    idx, dist = jknn.prototype_topk(jnp.asarray(feats), jnp.asarray(bank),
                                    jnp.asarray(mask), k, distance,
                                    impl="xla")
    return np.asarray(idx), np.asarray(dist)


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("m,p,k", [(37, 300, 4), (8, 128, 2), (130, 700, 8)])
def test_plain_matches_xla(m, p, k, impl):
    feats, bank, mask = _inputs(m, p, 64, m + p + k)
    idx, dist = _port(feats, bank, mask, k, impl=impl)
    ref_idx, ref_dist = _xla(feats, bank, mask, k)
    assert idx.dtype == np.int32 and idx.shape == (m, k)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(dist, ref_dist, atol=DIST_ATOL)


def test_fewer_than_k_valid_follows_xla():
    """5 valid rows, k=8: the lowest masked indices fill the tail at +inf."""
    feats, bank, _ = _inputs(4, 256, 32, 0)
    mask = np.arange(256) < 5
    idx, dist = _port(feats, bank, mask, 8)
    ref_idx, ref_dist = _xla(feats, bank, mask, 8)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(dist, ref_dist, atol=DIST_ATOL)
    np.testing.assert_array_equal(idx[:, 5:], [[5, 6, 7]] * 4)
    assert np.isinf(dist[:, 5:]).all() and np.isfinite(dist[:, :5]).all()
    assert sorted(idx[0, :5]) == [0, 1, 2, 3, 4]


def test_pallas_divergence_on_fewer_than_k_is_not_copied():
    """With fewer than k valid rows the JAX Pallas kernel repeats one index
    in the tail where the xla path takes the next masked rows; the port
    follows xla. This pins the divergence recorded in ROADMAP.md."""
    feats, bank, _ = _inputs(4, 256, 32, 0)
    mask = np.arange(256) < 5
    idx, _ = _port(feats, bank, mask, 8)
    pal_idx, pal_dist = cosine_knn_pallas(
        jnp.asarray(feats), jnp.asarray(bank), jnp.asarray(mask), k=8,
        m_tile=8, p_tile=128, interpret=True)
    pal_idx = np.asarray(pal_idx)
    np.testing.assert_array_equal(pal_idx[:, :5], idx[:, :5])
    assert np.isinf(np.asarray(pal_dist)[:, 5:]).all()
    assert (idx[:, 5:] == [5, 6, 7]).all()
    assert not (pal_idx[:, 5:] == idx[:, 5:]).all()


@pytest.mark.parametrize("m,p,k", [(37, 300, 4), (8, 128, 2), (130, 700, 8)])
def test_plain_matches_pallas_interpret_where_k_rows_are_valid(m, p, k):
    feats, bank, mask = _inputs(m, p, 64, 7 * m + p)
    idx, dist = _port(feats, bank, mask, k)
    pal_idx, pal_dist = cosine_knn_pallas(
        jnp.asarray(feats), jnp.asarray(bank), jnp.asarray(mask), k=k,
        m_tile=8, p_tile=128, interpret=True)
    assert mask.sum() >= k
    np.testing.assert_array_equal(idx, np.asarray(pal_idx))
    np.testing.assert_allclose(dist, np.asarray(pal_dist), atol=DIST_ATOL)


def test_batched_matches_vmapped_jax():
    """One (T, M, F) call against the JAX op vmapped over T, as
    ``GraphONE.interact`` calls it; each task has its own mask."""
    feats, bank, mask = _inputs(24, 320, 48, 11, t=3)
    mask[2, 4:] = False  # one task with fewer than k valid rows
    idx, dist = _port(feats, bank, mask, 8)
    ref_idx, ref_dist = jax.vmap(
        lambda f, b, m: jknn.prototype_topk(f, b, m, 8, impl="xla"))(
        jnp.asarray(feats), jnp.asarray(bank), jnp.asarray(mask))
    assert idx.shape == (3, 24, 8)
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_allclose(dist, np.asarray(ref_dist), atol=DIST_ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_l2_matches_jax(batched):
    feats, bank, mask = _inputs(20, 150, 32, 3, t=2 if batched else None)
    idx, dist = _port(feats, bank, mask, 5, distance="l2")
    if batched:
        ref_idx, ref_dist = jax.vmap(
            lambda f, b, m: jknn.prototype_topk(f, b, m, 5, "l2",
                                                impl="xla"))(
            jnp.asarray(feats), jnp.asarray(bank), jnp.asarray(mask))
    else:
        ref_idx, ref_dist = _xla(feats, bank, mask, 5, "l2")
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_allclose(dist, np.asarray(ref_dist), rtol=1e-5,
                               atol=1e-7)


def test_distances_match_jax():
    feats, bank, _ = _inputs(9, 40, 16, 2)
    f, b = torch.from_numpy(feats), torch.from_numpy(bank)
    np.testing.assert_allclose(
        tknn.cosine_dissimilarity(f, b).numpy(),
        np.asarray(jknn.cosine_dissimilarity(jnp.asarray(feats),
                                             jnp.asarray(bank))),
        atol=DIST_ATOL)
    np.testing.assert_allclose(
        tknn.l2_distance(f, b).numpy(),
        np.asarray(jknn.l2_distance(jnp.asarray(feats), jnp.asarray(bank))),
        rtol=1e-5, atol=1e-7)


def test_no_gradient_and_no_kernel_on_the_cpu():
    feats, bank, mask = _inputs(6, 64, 16, 1)
    f = torch.from_numpy(feats).requires_grad_()
    launches = tkt.cosine_knn.launches
    idx, dist = tknn.prototype_topk(f, torch.from_numpy(bank),
                                    torch.from_numpy(mask), 3)
    assert not dist.requires_grad
    assert tkt.cosine_knn.launches == launches
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tknn.prototype_topk(f, torch.from_numpy(bank), torch.from_numpy(mask),
                            3, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        tknn.prototype_topk(f, torch.from_numpy(bank), torch.from_numpy(mask),
                            3, impl="pallas")


def test_wrapper_checks():
    feats, bank, mask = (torch.from_numpy(a) for a in _inputs(6, 64, 16, 1,
                                                                t=2))
    with pytest.raises(ValueError, match="at most 32"):
        tkt.cosine_knn(feats, bank, mask, 33)
    with pytest.raises(ValueError, match="must lie in"):
        tkt.cosine_knn(feats, bank[:, :4], mask[:, :4], 5)
    with pytest.raises(TypeError, match="mask must be bool"):
        tkt.cosine_knn(feats, bank, mask.int(), 3)
    with pytest.raises(ValueError, match="differ"):
        tkt.cosine_knn(feats, bank[:1], mask[:1], 3)


@pytest.mark.parametrize("p", [1, 63, 64, 65, 1999, 2048, 55040])
@pytest.mark.parametrize("t,m", [(1, 1), (3, 64), (3, 8), (2, 300)])
def test_p_splits_cover_every_tile(t, m, p):
    """Pass 1's P-split (host logic of the wrapper): every split owns at
    least one tile of ``TILE_COLS`` bank rows and together they cover the
    bank."""
    for sms in (1, 132):
        s = tkt.num_splits(t, m, p, sms)
        tiles = -(-p // tkt.TILE_COLS)
        per = -(-tiles // s)
        assert 1 <= s <= tiles
        assert (s - 1) * per < tiles <= s * per


def _kernel_constants():
    """The ``constexpr int`` constants of ``csrc/knn_topk.cu`` whose values
    are arithmetic of numbers and earlier constants."""
    src = (Path(tkt.__file__).parent / "csrc" / "knn_topk.cu").read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        expr = re.sub(r"\b(k\w+)\b", lambda m: str(consts.get(m[1], m[1])),
                      expr.replace("/", "//"))
        if re.fullmatch(r"[\d\s*+/()-]+", expr):
            consts[name] = eval(expr)  # numbers and operators only
    return consts


@pytest.mark.parametrize("c_name,py_name", [
    ("kMaxK", "MAX_K"), ("kRows", "TILE_ROWS"), ("kCols", "TILE_COLS"),
    ("kThreads", "THREADS")])
def test_wrapper_constants_match_the_kernel_source(c_name, py_name):
    """The wrapper's tile constants (the P-split, the k limit) are the
    kernel's: a mismatch would split P into tiles the kernel does not walk."""
    assert _kernel_constants()[c_name] == getattr(tkt, py_name)


def test_near_tie_swaps_accepts_ties_only():
    ref_i = torch.tensor([[3, 1, 2, 0]], dtype=torch.int32)
    ref_d = torch.tensor([[0.1, 0.2, 0.200004, float("inf")]])
    assert tkt.near_tie_swaps(ref_i, ref_d, ref_i, ref_d) == 0
    swapped = torch.tensor([[3, 2, 1, 0]], dtype=torch.int32)
    assert tkt.near_tie_swaps(swapped, ref_d, ref_i, ref_d) == 2
    edge_i = torch.tensor([[3, 1, 2, 9]], dtype=torch.int32)
    edge_ref_d = torch.tensor([[0.1, 0.2, 0.3, 0.4]])
    assert tkt.near_tie_swaps(edge_i, edge_ref_d + 1e-6, ref_i,
                              edge_ref_d) == 1
    with pytest.raises(AssertionError, match="no near-tie"):
        tkt.near_tie_swaps(torch.tensor([[1, 3, 2, 0]], dtype=torch.int32),
                           ref_d, ref_i, ref_d)
    with pytest.raises(AssertionError, match="distance at"):
        tkt.near_tie_swaps(ref_i, ref_d + 1e-4, ref_i, ref_d)
