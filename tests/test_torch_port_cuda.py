"""The port's CUDA kernels (fused Adam, cosine k-NN) against their plain
PyTorch versions, on the card.

Skips on a host without CUDA: the kernel has no CPU mode. This file imports
only torch and the port, so it runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_port_cuda.py``."""

import pytest
import torch

from egopack_torch.ops import fused_adam as tfa
from egopack_torch.ops import knn_topk as tkt


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
