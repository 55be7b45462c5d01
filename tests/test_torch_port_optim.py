"""The port's Adam against ``egopack_tpu``'s: the plain fused-Adam version
against the Pallas ``fused_adam_leaf`` (run in interpret mode on the CPU, as
the JAX package's own tests run it), several steps of ``adam`` with a frozen
subtree, and the LR schedules.

Tolerances: float32 state rtol 1e-6 / atol 1e-7 (same operations, one
rounding apart at most); bfloat16 moments one bf16 unit (rtol 2**-7), since
an f32 difference in the last bit can round the stored moment either way;
parameters after several steps with bfloat16 moments atol lr/100, since such
a flipped moment moves that step's update by about 2**-8 of lr."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egopack_tpu.ops.pallas.fused_adam import fused_adam_leaf
from egopack_tpu.train import optim as jopt
from egopack_torch.ops import fused_adam as tfa
from egopack_torch.train import optim as topt

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-7)
HYPER = dict(wd=0.01, b1=0.9, b2=0.999, eps=1e-8)
# (256, 128) and (128, 256) take the Pallas path (>= 16384 elements, a
# multiple of 128); (33, 7) and (1000,) the jnp path
SHAPES = [(256, 128), (128, 256), (33, 7), (1000,)]


def _state(shape, seed):
    rng = np.random.default_rng(seed)
    p, g, m = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    v = np.abs(rng.normal(size=shape)).astype(np.float32) * 1e-2
    return p, g, m * 1e-2, v


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_leaf(shape, moments):
    p, g, m, v = _state(shape, seed=len(shape) + shape[0])
    bc1, bc2 = tfa.bias_corrections(HYPER["b1"], HYPER["b2"], 3)
    lr = 1e-3
    jm_dtype = jnp.dtype(moments)
    jp, jmo, jv = jax.jit(lambda *a: fused_adam_leaf(
        *a, jnp.float32(lr), jnp.float32(bc1), jnp.float32(bc2),
        m_dtype=jm_dtype, **HYPER))(jnp.asarray(p), jnp.asarray(g),
                                     jnp.asarray(m, jm_dtype),
                                     jnp.asarray(v, jm_dtype))
    # the port updates its state in place, so it gets copies: on the CPU
    # jnp.asarray keeps a 64-byte-aligned numpy buffer without copying, and
    # the jitted call, dispatched asynchronously, may read m and v after the
    # port has written them
    tm_dtype = getattr(torch, moments)
    tp, tg = torch.from_numpy(p.copy()), torch.from_numpy(g)
    tm = torch.from_numpy(m.copy()).to(tm_dtype)
    tv = torch.from_numpy(v.copy()).to(tm_dtype)
    tfa.fused_adam_reference(tp, tg, tm, tv, lr, bc1, bc2, **HYPER)
    mom_tol = F32_TOL if moments == "float32" else BF16_TOL
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **F32_TOL)
    for ours, ref in ((tm, jmo), (tv, jv)):
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(ref, np.float32), **mom_tol)


def test_bias_corrections_are_float32():
    for count in (1, 2, 7, 1000):
        c = jnp.asarray(count, jnp.int32).astype(jnp.float32)
        ref = (float(1 - 0.9 ** c), float(1 - 0.999 ** c))
        np.testing.assert_allclose(tfa.bias_corrections(0.9, 0.999, count),
                                   ref, rtol=1.2e-7)


@pytest.mark.parametrize("impl", ["fused", "optax"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_five_steps_with_frozen_subtree(impl, moments):
    rng = np.random.default_rng(0)
    tree = {"a": {"kernel": rng.normal(size=(128, 256)),
                  "bias": rng.normal(size=(256,))},
            "b": {"kernel": rng.normal(size=(33, 7))},
            "frozen": {"kernel": rng.normal(size=(16, 16))}}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    names = {"a.kernel": ("a", "kernel"), "a.bias": ("a", "bias"),
             "b.kernel": ("b", "kernel"), "frozen.kernel": ("frozen", "kernel")}
    jo = jopt.adam(1e-3, 0.01, impl="fused", moments_dtype=moments,
                   trainable_mask=lambda p: {
                       k: jax.tree_util.tree_map(lambda _: k != "frozen", v)
                       for k, v in p.items()})
    to = topt.adam(1e-3, 0.01, impl=impl, moments_dtype=moments,
                   trainable_mask=topt.trainable_mask_fn(["a", "b"]))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jo.init(jp)
    tp = {n: torch.from_numpy(tree[k][leaf].copy())
          for n, (k, leaf) in names.items()}
    tstate = to.init(tp)
    apply = jax.jit(jo.fused_apply)
    for i in range(5):
        g_rng = np.random.default_rng(100 + i)
        grads = {n: g_rng.normal(size=tp[n].shape).astype(np.float32)
                 for n in names}
        lr = 1e-3 * 0.9 ** i
        jstate.hyperparams["learning_rate"] = jnp.float32(lr)
        jgrads = {k: {leaf: jnp.asarray(grads[n]) if k != "frozen"
                      else jnp.zeros_like(jp[k][leaf])
                      for n, (kk, leaf) in names.items() if kk == k}
                  for k in tree}
        jp, jstate = apply(jgrads, jstate, jp)
        tstate.hyperparams["learning_rate"] = lr
        # the frozen leaf has no gradient, as torch leaves it None
        to.apply({n: torch.from_numpy(g) for n, g in grads.items()
                  if not n.startswith("frozen")}, tstate, tp)
    assert tstate.count == 5
    tol = F32_TOL if moments == "float32" else dict(rtol=0, atol=1e-3 / 100)
    for n, (k, leaf) in names.items():
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[k][leaf]),
                                   err_msg=n, **tol)
    np.testing.assert_array_equal(tp["frozen.kernel"].numpy(),
                                  tree["frozen"]["kernel"])
    assert not tstate.mu["frozen.kernel"].any()
    assert not tstate.nu["frozen.kernel"].any()


def test_lr_schedules_match():
    for warm in (False, True):
        ours = topt.build_lr_fn(1e-3, topt.cosine_annealing(10, 1e-6), warm)
        ref = jopt.build_lr_fn(1e-3, jopt.cosine_annealing(10, 1e-6), warm)
        assert [ours(e) for e in range(12)] == [ref(e) for e in range(12)]
    assert ([topt.linear_warmup(0.1, 1.0, 3)(e) for e in range(5)]
            == [jopt.linear_warmup(0.1, 1.0, 3)(e) for e in range(5)])


def test_unknown_impl_raises():
    with pytest.raises(ValueError):
        topt.adam(impl="pallas")

