"""Checkpoint helpers (counterpart of ``egopack_tpu/train/checkpoint.py``,
the part that phase 2 needs so far)."""

from __future__ import annotations

from typing import Dict

import torch

State = Dict[str, torch.Tensor]


def merge_loaded_params(params: State, loaded: State) -> State:
    """``load_state_dict(strict=False)`` semantics (reference
    main_egopack.py:290-295) over torch states (``{dotted name: tensor}``,
    see ``interop``): every loaded leaf that ``params`` names is taken, and
    the fresh values stay where ``loaded`` has none (the phase-2 heads'
    aux classifiers and GraphONE are not in a phase-1 state). Leaves of
    ``loaded`` that ``params`` does not name are dropped."""
    return {name: loaded.get(name, value) for name, value in params.items()}
