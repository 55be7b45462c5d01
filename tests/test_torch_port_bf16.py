"""bf16 activation propagation (``propagate_dtype=bfloat16``) against the
JAX package: ``TLinear(dtype=bfloat16)``, ``DenseSAGEConv`` (``__call__``,
``concat``, ``multi``), ``TRNPooling``, ``TemporalGraph`` and the phase-1
losses, with the same weights (``interop.from_flax``) and numpy inputs.

Tolerance: one bf16 unit, rtol 2**-7, with an absolute floor of one unit of
the output's largest magnitude (a bf16 sum of two rounded terms can land
near zero); the two packages round at the same places, so most outputs
agree bit for bit. The phase-1 losses (bf16 compute and propagation) must
sit closer to JAX's bf16 losses than a quarter of JAX's own gap between its
bf16 and float32 losses, and within rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from egopack_tpu.models import layers as jlayers
from egopack_tpu.models.backbone import TemporalGraph as JTemporalGraph
from egopack_tpu.models.pooling import TRNPooling as JTRN
from egopack_torch import entry as tentry
from egopack_torch import interop
from egopack_torch.models import layers as tlayers
from egopack_torch.models.backbone import TemporalGraph
from egopack_torch.models.pooling import TRNPooling
from torch_port_common import ACTIVE, BF16_UNIT, FEAT, HIDDEN, to_np

torch.set_num_threads(1)
H = 8


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _chain_adj(n):
    adj = np.zeros((n, n), bool)
    idx = np.arange(n - 2)  # the last node has no in-neighbours
    adj[idx + 1, idx] = adj[idx, idx + 1] = True
    return adj


def _load(module, params):
    module.load_state_dict(interop.from_flax(to_np(params)))
    return module


def close_bf16(ours, ref):
    """One bf16 unit, relative, with a floor of one unit of the largest
    magnitude."""
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    o = ours.detach().float().numpy()
    r = np.asarray(ref, np.float32)
    np.testing.assert_allclose(o, r, rtol=BF16_UNIT,
                               atol=BF16_UNIT * np.abs(r).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tlinear_bf16_output_and_gradients(dtype):
    """bf16 operands from either input dtype, bf16 result; the gradients
    are float32 products rounded to bf16 on both sides."""
    x = _x(3, 5, 6)
    jm = jlayers.TLinear(7, dtype=jnp.bfloat16)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tm = _load(tlayers.TLinear(6, 7, dtype="bfloat16", device="cpu"), p)
    jx = jnp.asarray(x, dtype)
    close_bf16(tm(torch.from_numpy(x).to(getattr(torch, dtype))),
               jm.apply({"params": p}, jx))

    def jloss(p, x):
        return jnp.sum(jm.apply({"params": p}, x).astype(jnp.float32) ** 2)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (tm(tx).float() ** 2).sum().backward()
    jg = interop.from_flax(to_np(jgp))
    for name, param in tm.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), jg[name].numpy(),
                                   rtol=BF16_UNIT, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=BF16_UNIT, atol=1e-6)


@pytest.mark.parametrize("form", ["call", "call_batched_adj", "concat",
                                  "multi"])
def test_dense_sage_conv_bf16(form):
    """The mean aggregation casts to bf16 before its bf16 division by the
    degree, as JAX does."""
    jm = jlayers.DenseSAGEConv(H, project=True, dtype=jnp.bfloat16)
    x = _x(2, 6, H)
    adj = _chain_adj(6)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                jnp.asarray(adj))["params"]
    tm = _load(tlayers.DenseSAGEConv(H, H, project=True, dtype="bfloat16",
                                     device="cpu"), p)
    if form == "call_batched_adj":
        adj = np.stack([adj, _chain_adj(6).T])
    if form in ("call", "call_batched_adj"):
        close_bf16(tm(torch.from_numpy(x), torch.from_numpy(adj)),
                   jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(adj)))
    elif form == "concat":
        x_cc = _x(1, 12, H, seed=1)
        adj_cc = np.zeros((12, 12), bool)
        adj_cc[:6, :6] = adj
        adj_cc[6:, 6:] = _chain_adj(6)
        close_bf16(tm.concat(torch.from_numpy(x_cc),
                             torch.from_numpy(adj_cc)),
                   jm.apply({"params": p}, jnp.asarray(x_cc),
                            jnp.asarray(adj_cc), method="concat"))
    else:
        xs = [x, _x(3, 4, H, seed=2)]
        adjs = [adj, _chain_adj(4)]
        refs = jm.apply({"params": p}, [jnp.asarray(a) for a in xs],
                        [jnp.asarray(a) for a in adjs], method="multi")
        ours = tm.multi([torch.from_numpy(a) for a in xs],
                        [torch.from_numpy(a) for a in adjs])
        for o, r in zip(ours, refs):
            close_bf16(o, r)


def test_trn_pooling_bf16():
    x = _x(2, 5, 3, FEAT)
    jm = JTRN(FEAT, HIDDEN, 3, hidden_size=HIDDEN, dtype=jnp.bfloat16)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tm = _load(TRNPooling(FEAT, HIDDEN, 3, hidden_size=HIDDEN,
                          dtype=torch.bfloat16, device="cpu"), p)
    close_bf16(tm(torch.from_numpy(x)), jm.apply({"params": p},
                                                 jnp.asarray(x)))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_temporal_graph_bf16(x_dtype):
    """The whole backbone: pooling, three SAGE layers with graph LayerNorms
    computed in float32, LeakyReLU with the bf16 slope, ``out_lin`` and the
    bf16 residual."""
    x = _x(2, 5, 3, FEAT)
    adj, pos = _chain_adj(5), np.arange(5, dtype=np.float32)
    mask = np.ones((2, 5), bool)
    mask[1, 3:] = False
    jm = JTemporalGraph(FEAT, HIDDEN, depth=3, num_segments=3,
                        propagate_dtype=jnp.bfloat16)
    args = (x, adj, pos, mask)
    p = jm.init(jax.random.PRNGKey(1), *map(jnp.asarray, args))["params"]
    tm = _load(TemporalGraph(FEAT, HIDDEN, depth=3, num_segments=3,
                             propagate_dtype="bfloat16", device="cpu"), p)
    jx = jnp.asarray(x, x_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    close_bf16(tm(tx, *map(torch.from_numpy, args[1:])),
               jm.apply({"params": p}, jx, *map(jnp.asarray, args[1:])))


@pytest.mark.parametrize("layout", ["concat", "slice"])
def test_phase1_losses_bf16_propagation(layout):
    """compute_dtype and propagate_dtype bf16 on both sides: the port's
    losses against JAX's, measured against JAX's own bf16-to-float32 gap.
    The system casts the backbone's output to float32 before the heads."""
    losses = {}
    for prop in (None, jnp.bfloat16):
        jsys = ge._build_system(HIDDEN, HIDDEN, FEAT, tp_dropout=0.0,
                                propagate_dtype=prop)
        jsys.fused_layout = layout
        jsys.compute_dtype = jnp.bfloat16
        params = jsys.init_params(jax.random.PRNGKey(0), FEAT)
        jb = ge._synthetic_batches(jsys, 2, FEAT, seed=0)
        _, logs = jsys._make_phase1_loss_fn(ACTIVE)(params, jb,
                                                    jax.random.PRNGKey(0))
        losses[prop] = {k: float(v) for k, v in logs.items()}
    tsys = tentry.build_system(HIDDEN, HIDDEN, FEAT, tp_dropout=0.0,
                               compute_dtype=torch.bfloat16,
                               propagate_dtype="bfloat16",
                               fused_layout=layout, device="cpu")
    tsys.load_state(interop.from_flax(to_np(params)))
    feat, _ = tsys.backbone_features(tentry.to_device(to_np(jb), "cpu")["ar"],
                                     "ar", False, None)
    assert feat.dtype == torch.float32
    _, tlogs = tsys._make_phase1_loss_fn(ACTIVE)(
        tentry.to_device(to_np(jb), "cpu"), None)
    ref, f32 = losses[jnp.bfloat16], losses[None]
    assert set(tlogs) == set(ref)
    for key, v in ref.items():
        ours = float(tlogs[key].detach())
        assert abs(ours - v) <= 0.25 * abs(v - f32[key]), (key, ours, v,
                                                           f32[key])
        np.testing.assert_allclose(ours, v, rtol=1e-5, err_msg=key)


def test_propagate_dtype_names():
    for value, want in ((None, None), ("float32", torch.float32),
                        ("bfloat16", torch.bfloat16),
                        (torch.bfloat16, torch.bfloat16)):
        assert tlayers.resolve_dtype(value) is want
    with pytest.raises(ValueError, match="float16"):
        tlayers.resolve_dtype("float16")
