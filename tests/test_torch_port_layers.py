"""The port's layers, pooling and backbone against the flax modules of
``egopack_tpu.models`` with the same weights (``interop.from_flax``) and the
same numpy inputs. Tolerance: rtol 1e-4 / atol 1e-5 (f32 sums in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egopack_tpu.models import layers as jlayers
from egopack_tpu.models.pooling import TRNPooling as JTRN
from egopack_torch import interop
from egopack_torch.models import layers as tlayers
from egopack_torch.models.pooling import TRNPooling
from egopack_torch.train.system import lta_full_adjacency
from torch_port_common import (HIDDEN, MODULE_TOL, batches, close, jax_system,
                               to_np, torch_system)

torch.set_num_threads(1)
H = 8


def _init(module, *args, method=None):
    return module.init(jax.random.PRNGKey(1), *args, method=method)["params"]


def _load(module, params):
    module.load_state_dict(interop.from_flax(to_np(params)))
    return module


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _chain_adj(n):
    adj = np.zeros((n, n), bool)
    idx = np.arange(n - 2)  # the last node has no in-neighbours
    adj[idx + 1, idx] = adj[idx, idx + 1] = True
    return adj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tlinear(dtype):
    x = _x(3, 5, 6)
    jm = jlayers.TLinear(7)
    p = _init(jm, jnp.asarray(x))
    tm = _load(tlayers.TLinear(6, 7, device="cpu"), p)
    ref = jm.apply({"params": p}, jnp.asarray(x, dtype))
    ours = tm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    close(ours, ref, **MODULE_TOL)


def test_layer_norm():
    x = _x(4, 5, H) * 3 + 1
    jm = jlayers.LayerNorm()
    p = jax.tree_util.tree_map(lambda a: a + 0.5, _init(jm, jnp.asarray(x)))
    tm = _load(tlayers.LayerNorm(H, device="cpu"), p)
    close(tm(torch.from_numpy(x)), jm.apply({"params": p}, jnp.asarray(x)),
          **MODULE_TOL)


@pytest.mark.parametrize("branch", ["whole", "node_mask", "task_onehot"])
def test_graph_layer_norm(branch):
    jm = jlayers.GraphLayerNorm()
    if branch == "task_onehot":
        x = _x(1, 10, H) * 2 + 1
        mask = np.ones(10, bool)
        mask[[2, 7]] = False
        onehot = np.zeros((2, 10), np.float32)
        onehot[0, :4] = onehot[1, 4:] = 1
        args = (x, mask, onehot)
    elif branch == "node_mask":
        x = _x(3, 5, H) * 2 + 1
        mask = np.ones((3, 5), bool)
        mask[1] = False
        args = (x, mask)
    else:
        x = _x(3, 5, H) * 2 + 1
        args = (x,)
    p = jax.tree_util.tree_map(lambda a: a * 1.5, _init(jm, jnp.asarray(x)))
    tm = _load(tlayers.GraphLayerNorm(H, device="cpu"), p)
    close(tm(*map(torch.from_numpy, args)),
          jm.apply({"params": p}, *map(jnp.asarray, args)), **MODULE_TOL)


@pytest.mark.parametrize("form", ["call_shared_adj", "call_batched_adj",
                                  "concat", "multi"])
def test_dense_sage_conv(form):
    jm = jlayers.DenseSAGEConv(H, project=True)
    x = _x(2, 6, H)
    adj = _chain_adj(6)
    p = _init(jm, jnp.asarray(x), jnp.asarray(adj))
    tm = _load(tlayers.DenseSAGEConv(H, H, project=True, device="cpu"), p)
    if form == "call_batched_adj":
        adj = np.stack([adj, _chain_adj(6).T & False])  # 2nd: no edges at all
    if form in ("call_shared_adj", "call_batched_adj"):
        ref = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(adj))
        ours = tm(torch.from_numpy(x), torch.from_numpy(adj))
        close(ours, ref, **MODULE_TOL)
    elif form == "concat":
        m = 12
        x_cc = _x(1, m, H, seed=1)
        adj_cc = np.zeros((m, m), bool)
        adj_cc[:6, :6] = adj
        adj_cc[6:, 6:] = _chain_adj(6)
        ref = jm.apply({"params": p}, jnp.asarray(x_cc), jnp.asarray(adj_cc),
                       method="concat")
        close(tm.concat(torch.from_numpy(x_cc), torch.from_numpy(adj_cc)),
              ref, **MODULE_TOL)
    else:
        xs = [x, _x(3, 4, H, seed=2)]
        adjs = [adj, _chain_adj(4)]
        refs = jm.apply({"params": p}, [jnp.asarray(a) for a in xs],
                        [jnp.asarray(a) for a in adjs], method="multi")
        ours = tm.multi([torch.from_numpy(a) for a in xs],
                        [torch.from_numpy(a) for a in adjs])
        for o, r in zip(ours, refs):
            close(o, r, **MODULE_TOL)


@pytest.mark.parametrize("channels", [32, 2, 1])
def test_positional_encoding(channels):
    pos = np.arange(22, dtype=np.float32) - 4
    close(tlayers.positional_encoding(torch.from_numpy(pos), channels),
          jlayers.positional_encoding(jnp.asarray(pos), channels),
          **MODULE_TOL)


def test_trn_pooling():
    x = _x(2, 5, 3, 6)
    jm = JTRN(input_size=6, output_size=H, num_segments=3, hidden_size=12)
    p = _init(jm, jnp.asarray(x))
    tm = _load(TRNPooling(6, H, 3, hidden_size=12, device="cpu"), p)
    close(tm(torch.from_numpy(x)), jm.apply({"params": p}, jnp.asarray(x)),
          **MODULE_TOL)


def test_dropout_draws_from_the_generator():
    x = torch.ones(4000)
    g = torch.Generator().manual_seed(0)
    y = tlayers.dropout(x, 0.5, True, g)
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    assert 0.4 < (y == 0).float().mean() < 0.6
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(tlayers.dropout(x, 0.5, True, g2), y)
    assert tlayers.dropout(x, 0.5, False, None) is x
    with pytest.raises(ValueError):
        tlayers.dropout(x, 0.5, True, None)


@pytest.mark.parametrize("method", ["pool", "reason", "reason_multi",
                                    "reason_concat"])
def test_temporal_graph(method):
    jsys, params = jax_system()
    tsys = torch_system(params)
    jbb, tbb = jsys.backbone, tsys.backbone
    p = {"params": params["temporal_graph"]}
    if method == "pool":
        x = _x(2, 9, 3, 16)
        close(tbb.pool(torch.from_numpy(x)),
              jbb.apply(p, jnp.asarray(x), method="pool"), **MODULE_TOL)
        return
    jb, tb = batches(jsys)
    names = ("ar", "lta", "pnr")
    specs = [jsys.tasks[n].spec for n in names]
    hs = [_x(2, s.num_nodes, HIDDEN, seed=i) for i, s in enumerate(specs)]
    adjs = [np.asarray(lta_full_adjacency(torch.from_numpy(s.adjacency),
                                          tb[n]["y"], s.radius))
            if s.lta_extra else s.adjacency for n, s in zip(names, specs)]
    masks = [np.ones((2, s.num_nodes), bool) for s in specs]
    masks[0][1] = False  # a padded AR sample
    poss = [s.pos for s in specs]
    if method == "reason":
        ref = jbb.apply(p, jnp.asarray(hs[1]), jnp.asarray(adjs[1]),
                        jnp.asarray(poss[1]), jnp.asarray(masks[1]),
                        method="reason")
        ours = tbb.reason(*map(torch.from_numpy, (hs[1], adjs[1], poss[1],
                                                  masks[1])))
        close(ours, ref, **MODULE_TOL)
    elif method == "reason_multi":
        j = [[jnp.asarray(a) for a in arrs] for arrs in (hs, adjs, poss, masks)]
        t = [[torch.from_numpy(a) for a in arrs]
             for arrs in (hs, adjs, poss, masks)]
        for o, r in zip(tbb.reason_multi(*t),
                        jbb.apply(p, *j, method="reason_multi")):
            close(o, r, **MODULE_TOL)
    else:
        metas = [(n, 2, s.num_nodes) for n, s in zip(names, specs)]
        c = tsys._concat_static(metas)
        adj_cc = tsys._concat_adjacency(metas, tb, c)
        h_cc = np.concatenate([h.reshape(1, -1, HIDDEN) for h in hs], 1)
        mask_cc = np.concatenate([m.reshape(-1) for m in masks])
        args = (h_cc, adj_cc.numpy(), c.pos.numpy(), mask_cc,
                c.onehot.numpy())
        ref = jbb.apply(p, *map(jnp.asarray, args), method="reason_concat")
        close(tbb.reason_concat(*map(torch.from_numpy, args)), ref,
              **MODULE_TOL)
        # the block-diagonal adjacency is the per-task graphs side by side
        off = 0
        for a in adjs:
            a = np.broadcast_to(a, (2,) + a.shape[-2:])
            for b in range(2):
                n = a.shape[-1]
                np.testing.assert_array_equal(
                    adj_cc.numpy()[off:off + n, off:off + n], a[b])
                off += n
        assert adj_cc.sum() == sum(np.broadcast_to(a, (2,) + a.shape[-2:])
                                   .sum() for a in adjs)
