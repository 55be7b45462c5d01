"""The norms' sum of squares (``egopack_torch/ops/sum_squares.py``) and the
step's norm helper built on it (``train/system.py:_norms``), on the CPU:
the wrapper's contract (the plain version on CPU tensors, checks that
raise) and the slots that ``_norms`` hands it, from the split leaves and
from ``_layer_groups``. The kernel itself is held to a float64 sum on the
card (``tests/test_torch_port_cuda.py``); the norms of the steps are held
to JAX in ``test_torch_port_{norms,system,phase2}.py``.

This file imports only torch and the port."""

import pytest
import torch

from egopack_torch import entry
from egopack_torch.device import make_generator
from egopack_torch.ops import sum_squares as tss
from egopack_torch.parallel.collectives import SINGLE
from egopack_torch.train import system as tsystem

torch.set_num_threads(1)


def _leaves():
    gen = torch.Generator().manual_seed(0)
    shapes = [(1,), (3,), (4 * 2048 + 1,), (33, 7), (0,), (5, 4)]
    return [torch.randn(s, generator=gen) for s in shapes]


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper returns the plain version's numbers, bit for
    bit, counts no launch, and agrees with a float64 sum; a slot no leaf
    names reads 0."""
    leaves = _leaves()
    slots = [[0], [0, 2], [1], [1, 2], [0], [2]]
    launches = tss.sum_squares.launches
    for roots in (False, True):
        out = tss.sum_squares(leaves, slots, 4, roots=roots)
        ref = tss.sum_squares_reference(leaves, slots, 4, roots=roots)
        assert out.dtype == torch.float32 and out.shape == (4,)
        assert torch.equal(out, ref)
        sums = [t.double().square().sum() for t in leaves]
        zero = torch.zeros((), dtype=torch.float64)
        want = torch.stack([sum((x for x, named in zip(sums, slots)
                                 if s in named), zero) for s in range(4)])
        torch.testing.assert_close(out.double(),
                                   want.sqrt() if roots else want,
                                   rtol=1e-6, atol=0)
        assert float(out[3]) == 0.0
    assert tss.sum_squares.launches == launches


@pytest.mark.parametrize("bad", ["float64", "bfloat16", "transposed",
                                 "strided", "slot", "lengths", "empty",
                                 "no_slots"])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    leaves, slots, n = _leaves(), [[0]] * 6, 2
    if bad in ("float64", "bfloat16"):
        leaves[2] = leaves[2].to(getattr(torch, bad))
    elif bad == "transposed":
        leaves[3] = leaves[3].t()
    elif bad == "strided":
        leaves[2] = leaves[2][::2]
    elif bad == "slot":
        slots = [[0]] * 5 + [[n]]
    elif bad == "lengths":
        slots = slots[:-1]
    elif bad == "empty":
        leaves, slots = [], []
    else:
        n = 0
    with pytest.raises((TypeError, ValueError)):
        tss.sum_squares(leaves, slots, n, roots=True)


class _Recorder:
    """Stands in for ``sum_squares`` in ``train/system.py``: records each
    call's leaves, slots and flags, and answers with the plain version."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(tsystem, "sum_squares", self)

    def __call__(self, leaves, slots, n_slots, *, roots):
        self.calls.append((list(leaves), [list(s) for s in slots], n_slots,
                           roots))
        return tss.sum_squares_reference(leaves, slots, n_slots, roots=roots)


def _system():
    system = entry.build_system(16, 16, 12, device="cpu")
    system.init_params(make_generator(0, torch.device("cpu")))
    params = system.params()
    gen = torch.Generator().manual_seed(1)
    grads = {n: torch.randn(p.shape, generator=gen)
             for n, p in list(params.items())[::3]}
    return params, grads


def _plain_norm(named):
    return torch.sqrt(sum((torch.sum(torch.square(t)) for t in
                           named.values()), torch.zeros(())))


def test_slots_from_the_split_leaves(monkeypatch):
    """Leaves named in the split set go to the second half of the slots,
    each set's replicated leaves to the first; one call, no roots in it,
    and on a one-rank axis the norms equal the unsplit ones. With nothing
    split, the call takes the roots in its ``n`` slots."""
    rec = _Recorder(monkeypatch)
    params, grads = _system()
    sets = {"grad_norm": grads, "param_norm": params}
    split = set(list(params)[1::2])
    with torch.no_grad():
        whole = tsystem._norms(sets, (), SINGLE)
        halves = tsystem._norms(sets, split, SINGLE)
    (leaves0, slots0, n0, roots0), (leaves, slots, n, roots) = rec.calls
    assert (n0, roots0, n, roots) == (2, True, 4, False)
    assert all(len(s) == 1 for s in slots0)
    index = {id(t): i for i, t in enumerate(leaves)}
    for k, (key, named) in enumerate(sets.items()):
        for name, t in named.items():
            assert k + 2 * (name in split) in slots[index[id(t)]], name
    for key, named in sets.items():
        torch.testing.assert_close(halves[key], whole[key], rtol=1e-6,
                                   atol=0)
        assert torch.equal(whole[key], _plain_norm(named)), key


def test_slots_from_the_layer_groups(monkeypatch):
    """The global and the per-layer norms come from one call that reads each
    tensor once: a parameter counts in ``param_norm`` and in its subtree's
    slot, a gradient in ``grad_norm`` and in its subtree's; the subtrees are
    ``_layer_groups``'s, JAX's keys; a subtree without trainable leaves
    reads a gradient norm of 0."""
    rec = _Recorder(monkeypatch)
    params, grads = _system()
    sets = {"grad_norm": grads, "param_norm": params,
            **tsystem._subtree_sets(params, grads)}
    with torch.no_grad():
        out = tsystem._norms(sets, (), SINGLE)
    (leaves, slots, n, roots), = rec.calls
    assert n == len(sets) and roots
    assert len({id(t) for t in leaves}) == len(leaves) == \
        len(params) + len(grads)
    keys = list(sets)
    groups = tsystem._layer_groups(tuple(params))
    for key, members in groups.items():
        for src, name in ((params, "param_norm"), (grads, "grad_norm")):
            slot = keys.index(f"{name}/{key}")
            for m in members:
                if m in src:
                    i = next(i for i, t in enumerate(leaves)
                             if t is src[m])
                    assert sorted(slots[i]) == [keys.index(name), slot]
    assert all(len(s) == 2 for s in slots)
    for key, named in sets.items():
        assert torch.equal(out[key], _plain_norm(named)), key
    empty = [k for k, named in sets.items() if not named]
    assert empty and all(float(out[k]) == 0.0 for k in empty)
