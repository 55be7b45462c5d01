"""The port's CUDA kernels (fused Adam, cosine k-NN, the norms' sum of
squares) against their plain PyTorch versions or a float64 sum, on the
card.

Skips on a host without CUDA: the kernel has no CPU mode. This file imports
only torch and the port, so it runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_port_cuda.py``."""

import pytest
import torch

from egopack_torch import entry
from egopack_torch.models.graphone import GraphONE
from egopack_torch.ops import fused_adam as tfa
from egopack_torch.ops import knn_topk as tkt
from egopack_torch.ops import sum_squares as tss
from egopack_torch.parallel.collectives import SINGLE
from egopack_torch.train import driver
from egopack_torch.train import optim as topt
from egopack_torch.train import system as tsystem
from egopack_torch.train.system import CKPT_KEYS


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_the_card(moments):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(1536 * 3, 1024), (1024,), (33, 7), (115, 1024), (1,)] * 14
    m_dtype = getattr(torch, moments)

    def leaves():
        gen.manual_seed(0)
        ps = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
        ms = [torch.zeros(s, device="cuda", dtype=m_dtype) for s in shapes]
        vs = [torch.zeros(s, device="cuda", dtype=m_dtype) for s in shapes]
        return ps, ms, vs

    kern, plain = leaves(), leaves()
    launches = tfa.fused_adam.launches
    for count in (1, 2, 3):
        grads = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
        bc1, bc2 = tfa.bias_corrections(0.9, 0.999, count)
        kw = dict(wd=1e-5, b1=0.9, b2=0.999, eps=1e-8)
        tfa.fused_adam(kern[0], grads, kern[1], kern[2], 1e-3, bc1, bc2, **kw)
        bct = torch.tensor([bc1, bc2], device="cuda")
        for p, g, m, v in zip(plain[0], grads, plain[1], plain[2]):
            tfa.fused_adam_reference(p, g, m, v, 1e-3, bct[0], bct[1], **kw)
    torch.cuda.synchronize()
    assert tfa.fused_adam.launches - launches == 3 * 2  # 70 leaves, 64 a launch
    # built with --fmad=false the two agree bit for bit; one unit in the
    # last place of the stored dtype is the stated tolerance
    ulp = 2.0 ** -23 if moments == "float32" else 2.0 ** -7
    for a, b in zip(sum(kern, []), sum(plain, [])):
        torch.testing.assert_close(a, b, rtol=ulp if a.dtype == m_dtype
                                   else 2.0 ** -23, atol=0)
    assert all(torch.isfinite(p).all() for p in kern[0])


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,p,f,valid,k,rows", [
    (3, 64, 2048, 1024, 1900, 8, "normal"),  # the phase-2 step's shape
    (3, 64, 1999, 1024, 0.8, 8, "normal"),   # P not a multiple of the tile
    (3, 64, 256, 1024, 5, 8, "normal"),      # fewer than k valid rows
    (2, 37, 130, 30, 0.5, 32, "normal"),     # ragged M and F (no 16-byte
                                             # copies), k=32
    (3, 65, 2048, 1024, 1900, 8, "normal"),  # two row blocks, one ragged
    (3, 64, 55040, 1024, 50000, 8, "normal"),  # the full taxonomy: many
                                               # tiles a split
    (3, 64, 2048, 1024, 1900, 8, "scaled"),  # rows scaled over 1e-3..1e3
    (3, 64, 2048, 1024, 1900, 8, "pairs"),   # near-duplicate row pairs
])
def test_knn_kernel_matches_plain_version_on_the_card(t, m, p, f, valid, k,
                                                      rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(p)
    feats = torch.randn((t, m, f), device="cuda", generator=gen)
    bank = torch.randn((t, p, f), device="cuda", generator=gen)
    if rows == "scaled":  # the products' hi/lo split at any magnitude
        bank *= 10.0 ** (6 * torch.rand((t, p, 1), device="cuda",
                                        generator=gen) - 3)
    elif rows == "pairs":  # near-ties: rows 2i and 2i+1 differ by 1e-6 noise
        bank[:, 1::2] = bank[:, 0::2] + 1e-6 * torch.randn(
            (t, p // 2, f), device="cuda", generator=gen)
    if isinstance(valid, int):
        mask = (torch.arange(p, device="cuda") < valid).expand(t, p)
    else:
        mask = torch.rand((t, p), device="cuda", generator=gen) < valid
    bank[~mask] = 0.0  # padded rows are zeros: 0/0 if they were read
    launches = tkt.cosine_knn.launches
    idx, dist = tkt.cosine_knn(feats, bank, mask, k)
    torch.cuda.synchronize()
    assert tkt.cosine_knn.launches - launches == 1
    assert idx.dtype == torch.int32 and idx.shape == (t, m, k)
    ref_idx, ref_dist = tkt.cosine_knn_reference(feats, bank, mask, k)
    # distances within 1e-5; indices equal but for near-ties
    swaps = tkt.near_tie_swaps(idx, dist, ref_idx, ref_dist, atol=1e-5)
    assert not torch.isnan(dist).any()
    print(f"near-tie swaps {swaps}")


# ---------------- the norms' sum-of-squares kernel ----------------

FEAT, HIDDEN = 1536, 1024
# (every leaf, trainable leaves) of each cell's model
CELL_LEAVES = {"mtl-step": (69, 61), "novel-oscc-step": (101, 53),
               "novel-lta-step": (111, 28)}


def _cell_params(cell, dev, monkeypatch):
    """Every parameter of a cell's model at full width, by its name in
    ``MultiTaskSystem.params()``, drawn from a seeded normal, and the names
    that train. ``mtl-step``: phase 1, the backbone and the AR, LTA and PNR
    heads train. ``novel-oscc-step``: the heads' aux sets of
    ``entry.PHASE2_AUX``, GraphONE (k 4, depth 3, residual) over AR, LTA and
    PNR; the backbone, the OSCC head and GraphONE train.
    ``novel-lta-step``: the published aux sets (``driver.PHASE2_AUX``),
    GraphONE over AR, OSCC and PNR; the LTA head and GraphONE train."""
    if cell == "mtl-step":
        system = entry.build_system(HIDDEN, HIDDEN, FEAT, device=dev)
        trainable = ["temporal_graph"] + [CKPT_KEYS[t] for t in entry.ACTIVE]
    else:
        novel, aux = {"novel-oscc-step": ("oscc", entry.AUX_TASKS),
                      "novel-lta-step": ("lta", ("ar", "oscc", "pnr"))}[cell]
        if novel == "lta":
            monkeypatch.setattr(entry, "PHASE2_AUX", driver.PHASE2_AUX)
        system = entry.build_system(HIDDEN, HIDDEN, FEAT, phase2=True,
                                    device=dev)
        system.attach_graphone(GraphONE(aux, features_size=HIDDEN,
                                        hidden_size=HIDDEN, k=4, depth=3,
                                        residual=True, device=dev))
        trainable = [CKPT_KEYS[novel], "graphone"] + (
            ["temporal_graph"] if novel == "oscc" else [])
    params = system.params()
    gen = torch.Generator(device=dev).manual_seed(len(params))
    with torch.no_grad():
        for p in params.values():
            p.normal_(generator=gen)
    names = [n for n, on in topt.trainable_mask_fn(trainable)(params).items()
             if on]
    assert (len(params), len(names)) == CELL_LEAVES[cell]
    return params, names


def _f64_norms(sets, dev):
    """Each set's L2 norm, summed in float64."""
    return {k: torch.sqrt(sum((t.double().square().sum()
                               for t in named.values()),
                              torch.zeros((), dtype=torch.float64,
                                          device=dev)))
            for k, named in sets.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("cell", sorted(CELL_LEAVES))
def test_norms_kernel_on_each_cells_leaf_set(cell, split, monkeypatch):
    """The step's norms through the kernel (``system._norms``: the global
    ones and the per-layer ones of ``_subtree_sets``, in one call) against a
    float64 sum at rtol 1e-6, over a cell's full-width gradients and
    parameters; ``split``: every other leaf's squares summed over a
    one-rank axis, through the kernel's split slots. Two launches a call;
    two calls equal bit for bit; a call captured in a CUDA graph and
    replayed equals the eager call bit for bit."""
    dev = _card()
    params, names = _cell_params(cell, dev, monkeypatch)
    gen = torch.Generator(device=dev).manual_seed(7)
    grads = {n: torch.randn(params[n].shape, device=dev, generator=gen)
             for n in names}
    sets = {"grad_norm": grads, "param_norm": params,
            **tsystem._subtree_sets(params, grads)}
    shards = set(list(params)[::2]) if split else set()

    def norms():
        with torch.no_grad():
            return tsystem._norms(sets, shards, SINGLE)

    launches = tss.sum_squares.launches
    eager = norms()
    again = norms()
    torch.cuda.synchronize()
    assert tss.sum_squares.launches - launches == 4
    ref = _f64_norms(sets, dev)
    assert sorted(eager) == sorted(ref)
    for k, v in ref.items():
        assert eager[k].dtype == torch.float32 and eager[k].shape == ()
        torch.testing.assert_close(eager[k].double(), v, rtol=1e-6, atol=0,
                                   msg=lambda m: f"{k}: {m}")
        assert torch.equal(eager[k], again[k]), k
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = norms()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for k, v in eager.items():
        assert torch.equal(captured[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("roots", [False, True])
def test_sum_squares_kernel_on_ragged_and_unaligned_leaves(roots):
    """Leaves of 0, 1, 3 and 4k+1 elements, several chunks long, and views
    whose base lies 4, 8 or 12 bytes past a 16-byte boundary, in slots that
    share leaves, with a slot no leaf names: against a float64 sum at rtol
    1e-6."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    buf = torch.randn(3 * 8192 + 40, device=dev, generator=gen)
    leaves = [torch.randn(n, device=dev, generator=gen)
              for n in (1, 3, 4 * 2048 + 1, 4 * 5000 + 1, 8192, 0)]
    leaves += [buf[1:], buf[2:8192 + 7], buf[3:6], buf[5:6], buf[7:]]
    assert all(t.data_ptr() % 16 for t in leaves[6:])
    slots = [[i % 3, 3] if i % 2 else [i % 3] for i in range(len(leaves))]
    out = tss.sum_squares(leaves, slots, 5, roots=roots)
    torch.cuda.synchronize()
    sums = [t.double().square().sum() for t in leaves]
    for s in range(5):
        want = sum((x for x, named in zip(sums, slots) if s in named),
                   torch.zeros((), dtype=torch.float64, device=dev))
        want = want.sqrt() if roots else want
        torch.testing.assert_close(out[s].double(), want, rtol=1e-6, atol=0,
                                   msg=lambda m: f"slot {s}: {m}")
    assert float(out[4]) == 0.0
