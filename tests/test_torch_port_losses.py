"""The port's losses against ``egopack_tpu.ops.losses`` on the same numpy
inputs. Tolerance: rtol 1e-5 (f32 log-softmax and log1p)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egopack_tpu.ops import losses as jl
from egopack_torch.ops import losses as tl
from torch_port_common import LOSS_TOL, close

torch.set_num_threads(1)


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 9, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 9)).astype(np.int32)
    labels[:, ::2] = -1  # ignored nodes stay in the mean's denominator
    binary = rng.integers(0, 2, size=(3, 9, 11)).astype(np.float32)
    mask = rng.random((3, 9)) > 0.3
    return logits, labels, binary, mask


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy(data, smoothing):
    logits, labels, _, _ = data
    ours = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                            label_smoothing=smoothing)
    ref = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                           label_smoothing=smoothing)
    close(ours, ref, **LOSS_TOL)
    assert (ours.numpy()[labels == -1] == 0).all()


@pytest.mark.parametrize("fn,kw", [("bce_with_logits", {}),
                                   ("sigmoid_focal_loss", {}),
                                   ("sigmoid_focal_loss",
                                    {"alpha": -1.0, "gamma": 1.5})])
def test_binary_losses(data, fn, kw):
    logits, _, binary, _ = data
    ours = getattr(tl, fn)(torch.from_numpy(logits), torch.from_numpy(binary),
                           **kw)
    ref = getattr(jl, fn)(jnp.asarray(logits), jnp.asarray(binary), **kw)
    close(ours, ref, **LOSS_TOL)


@pytest.mark.parametrize("all_masked", [False, True])
def test_masked_mean(data, all_masked):
    logits, _, _, mask = data
    values = logits[..., 0]
    if all_masked:
        mask = np.zeros_like(mask)
    ours = tl.masked_mean(torch.from_numpy(values), torch.from_numpy(mask))
    ref = jl.masked_mean(jnp.asarray(values), jnp.asarray(mask))
    close(ours, ref, **LOSS_TOL)
