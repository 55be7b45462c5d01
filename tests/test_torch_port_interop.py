"""``egopack_torch.interop``: every leaf of the flax tree maps to exactly one
parameter of the port's modules, with the right shape, and back bit for
bit."""

import jax
import numpy as np
import torch

from egopack_torch import interop
from torch_port_common import (HIDDEN, P_PAD, jax_phase2, jax_system,
                               numpy_banks, to_np, torch_phase2, torch_system)

torch.set_num_threads(1)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(l)
            for path, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_every_leaf_maps_once_and_round_trips():
    _, params = jax_system()
    flax_np = to_np(params)
    state = interop.from_flax(flax_np)
    tsys = torch_system(params)
    model_state = tsys.model.state_dict()
    jleaves = _leaves(flax_np)
    assert len(state) == len(jleaves) == len(model_state) == 69
    assert set(state) == set(model_state)
    for name, t in state.items():
        assert t.shape == model_state[name].shape, name
        assert torch.equal(t, model_state[name]), name
    back = _leaves(interop.to_flax(model_state))
    assert set(back) == set(jleaves)
    for path, a in jleaves.items():
        assert back[path].dtype == a.dtype and back[path].shape == a.shape
        np.testing.assert_array_equal(back[path], a, err_msg=path)


def test_names_follow_the_flax_tree():
    state = interop.from_flax({"task/recognition": {"cls1": {"TLinear_0": {
        "kernel": np.zeros((4, 3), np.float32)}}},
        "temporal_graph": {"gn0": {"scale": np.ones(4, np.float32)}}})
    assert state["task.recognition.cls1.TLinear_0.weight"].shape == (3, 4)
    assert state["temporal_graph.gn0.weight"].shape == (4,)
    assert interop.top_level_key("task.lta.proj_fc0.bias") == "task/lta"
    assert interop.top_level_key("temporal_graph.sage0.lin_r.weight") == \
        "temporal_graph"


def test_phase2_tree_maps_once_and_round_trips():
    """The aux classifiers, the GraphONE stages and the trainable banks
    (``freeze=False``) map onto the phase-2 modules and back bit for bit."""
    banks = numpy_banks()
    _, _, params, _ = jax_phase2(banks, freeze=False)
    flax_np = to_np(params)
    tsys, _, _ = torch_phase2(params, banks, freeze=False)
    model_state = tsys.model.state_dict()
    jleaves = _leaves(flax_np)
    assert set(interop.from_flax(flax_np)) == set(model_state)
    assert len(model_state) == len(jleaves)
    assert model_state["graphone.w_l"].shape == (3, 3, HIDDEN, HIDDEN)
    assert model_state["graphone_banks.lta"].shape == (P_PAD, HIDDEN)
    assert model_state["task.oscc.aux_pnr_cls.TLinear_0.weight"].shape == \
        (2, HIDDEN)
    assert model_state["task.recognition.aux_lta_cls1.TLinear_0.weight"] \
        .shape == (478, HIDDEN)
    assert interop.top_level_key("graphone_banks.ar") == "graphone_banks"
    back = _leaves(interop.to_flax(model_state))
    assert set(back) == set(jleaves)
    for path, a in jleaves.items():
        assert back[path].dtype == a.dtype and back[path].shape == a.shape
        np.testing.assert_array_equal(back[path], a, err_msg=path)
