"""Artifacts and mid-run checkpoints (the port's counterpart of
``egopack_tpu/train/checkpoint.py``).

1. **Artifacts**, the hand-off between the phases:
   ``<artifact_dir>/<name>/checkpoint.msgpack`` and ``meta.json``, named
   ``MTL_<sorted tasks>`` as in the reference (``main_temporal.py:159``).
   The payload is the flax parameter tree (``interop.to_flax``) plus
   ``epoch`` (phase 2: plus the prototype banks and their masks), written
   by ``msgpack_codec`` in the bytes flax writes, so each package reads
   the other's artifacts; ``unpack_artifact`` splits one for a cold
   evaluation. A name already taken keeps
   its previous contents as ``checkpoint_v<n>.msgpack`` and
   ``meta_v<n>.json``.
2. **Mid-run resume**: the full train state (parameters, Adam moments and
   count, the run's generator state, the epoch) by ``torch.save`` into
   ``<dir>/step_<epoch>``, where the JAX package uses orbax. With
   ``async_write`` the state is copied to the host at once and written by a
   background thread; ``wait_for_saves`` waits for those writes.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import msgpack_codec

logger = logging.getLogger(__name__)

State = Dict[str, torch.Tensor]


def save_artifact(artifact_dir: str, name: str, payload: Dict[str, Any],
                  meta: Optional[Dict[str, Any]] = None) -> str:
    """Write a named artifact; ``payload`` is a tree of numpy leaves."""
    path = osp.join(artifact_dir, name)
    os.makedirs(path, exist_ok=True)
    ckpt = osp.join(path, "checkpoint.msgpack")
    if osp.exists(ckpt):
        # version the previous contents as wandb does: both phases use the
        # same artifact name, so a later save must not destroy the first
        v = 1
        while osp.exists(osp.join(path, f"checkpoint_v{v}.msgpack")):
            v += 1
        os.replace(ckpt, osp.join(path, f"checkpoint_v{v}.msgpack"))
        old_meta = osp.join(path, "meta.json")
        if osp.exists(old_meta):
            os.replace(old_meta, osp.join(path, f"meta_v{v}.json"))
        logger.warning(
            "Artifact %s existed; previous version kept as checkpoint_v%d",
            name, v)
    blob = msgpack_codec.packb(payload)
    with open(ckpt, "wb") as f:
        f.write(blob)
    with open(osp.join(path, "meta.json"), "w") as f:
        json.dump(meta or {}, f)
    return path


def load_artifact(artifact_dir: str,
                  ref: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load by reference: a bare ``NAME`` or wandb-style
    ``entity/project/NAME:alias``. Returns (numpy tree, meta)."""
    name = ref.split("/")[-1].split(":")[0]
    path = osp.join(artifact_dir, name)
    with open(osp.join(path, "checkpoint.msgpack"), "rb") as f:
        payload = msgpack_codec.unpackb(f.read())
    meta_path = osp.join(path, "meta.json")
    meta = {}
    if osp.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return payload, meta


def unpack_artifact(payload: Dict[str, Any], meta: Dict[str, Any], cfg,
                    device: DeviceLike = None):
    """Split a loaded artifact into its parameter overlay and its phase-2
    extras (egopack_tpu/train/checkpoint.py:100-150): pops ``epoch``, the
    banks, their masks and ``graphone`` from ``payload``, which is left as
    the flax tree of the system's parameters.

    Returns ``(phase2, banks, graphone, aux_tasks, late_fusion, extra)``:
    for a phase-2 artifact the banks as ``PrototypeBank`` on ``device``, a
    ``GraphONE`` from ``meta["graphone"]`` (zeros until its parameters are
    loaded), and ``extra``, the flax subtrees to merge over the system's
    (``graphone``; ``graphone_banks`` when the banks trained); for a
    phase-1 artifact ``(False, None, None, (), late_fusion, {})``. The port
    runs on one card, so the banks are never sharded."""
    from ..config import to_container
    from ..models.graphone import GraphONE, PrototypeBank

    dev = resolve_device(device)
    payload.pop("epoch", None)
    bank_vals = payload.pop("graphone_banks", None)
    bank_masks = payload.pop("graphone_bank_masks", None)
    gparams = payload.pop("graphone", None)
    late_fusion = bool(meta.get("late_fusion", cfg.late_fusion))
    if not (meta.get("phase") == "egopack" or gparams is not None):
        return False, None, None, (), late_fusion, {}
    if bank_vals is None or bank_masks is None:
        raise ValueError(
            "EgoPack artifact lacks prototype banks; it predates the "
            "complete phase-2 artifact format and cannot be reloaded cold")
    aux_tasks = tuple(meta.get("aux_tasks") or sorted(bank_vals))
    banks = {t: PrototypeBank(
        torch.as_tensor(np.array(bank_vals[t], np.float32), device=dev),
        torch.as_tensor(np.array(bank_masks[t], bool), device=dev))
        for t in bank_vals}
    gcfg = dict(meta.get("graphone") or to_container(cfg.graphone))
    graphone = GraphONE(task_labels=aux_tasks,
                        features_size=cfg.model.hidden_size, **gcfg,
                        device=dev)
    extra: Dict[str, Any] = {"graphone": gparams}
    if not gcfg.get("freeze", True):
        # trainable banks: the trained values are parameters too
        extra["graphone_banks"] = dict(bank_vals)
    return True, banks, graphone, aux_tasks, late_fusion, extra


def merge_loaded_params(params: State, loaded: State) -> State:
    """``load_state_dict(strict=False)`` semantics (reference
    main_egopack.py:290-295) over torch states (``{dotted name: tensor}``,
    see ``interop``): every loaded leaf that ``params`` names is taken, and
    the fresh values stay where ``loaded`` has none (the phase-2 heads'
    aux classifiers and GraphONE are not in a phase-1 state). Leaves of
    ``loaded`` that ``params`` does not name are dropped."""
    return {name: loaded.get(name, value) for name, value in params.items()}


# ---------------- full-state mid-run resume ----------------

_STEP_RE = re.compile(r"step_(\d+)")


def state_path(ckpt_dir: str, step: int) -> str:
    return osp.join(ckpt_dir, f"step_{step:06d}")


_pending: list = []  # background writes not yet waited for
_pending_lock = threading.Lock()


def _host_copy(tree):
    """A finished host copy of every tensor of ``tree``: the parameters and
    moments are updated in place by the next step (fused Adam), so a view
    or a pending copy would not do."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _write_state(path: str, state: Dict[str, Any]) -> None:
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def _write_in_background(path: str, state: Dict[str, Any]) -> None:
    errors: list = []

    def run():
        try:
            _write_state(path, state)
        except Exception as e:  # re-raised by wait_for_saves
            errors.append(e)

    t = threading.Thread(target=run, name=f"save {osp.basename(path)}")
    with _pending_lock:
        _pending.append((t, errors))
    t.start()


def save_state(ckpt_dir: str, step: int, state: Dict[str, Any],
               async_write: bool = False) -> None:
    """Write one full-state checkpoint. The file appears under its name
    only once complete (written beside it, then renamed), so a crash
    mid-save never leaves a checkpoint that ``latest_state`` would pick.

    ``async_write=True`` copies the state to the host before it returns and
    leaves the file write to a background thread (the JAX package's orbax
    ``AsyncCheckpointer``, egopack_tpu/train/checkpoint.py:170-203); call
    :func:`wait_for_saves` before reading the directory. Writes still
    pending when the interpreter exits are waited for then (the threads are
    not daemons)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = state_path(ckpt_dir, step)
    if async_write:
        _write_in_background(path, _host_copy(state))
    else:
        _write_state(path, state)


def wait_for_saves() -> None:
    """Block until every background write of :func:`save_state` has
    finished; re-raise the first error one of them met."""
    with _pending_lock:
        pending = list(_pending)
        _pending.clear()
    first = None
    for t, errors in pending:
        t.join()
        if errors and first is None:
            first = errors[0]
    if first is not None:
        raise first


def latest_state(ckpt_dir: str) -> Optional[int]:
    """Newest complete ``step_<n>`` in ``ckpt_dir``, or None."""
    if not osp.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_RE.fullmatch(d))]
    return max(steps) if steps else None


def restore_state(ckpt_dir: str, step: int,
                  device: torch.device) -> Dict[str, Any]:
    """The state :func:`save_state` wrote, its tensors on ``device``
    (generator states stay on the CPU, where ``set_state`` reads them)."""
    state = torch.load(state_path(ckpt_dir, step), map_location="cpu",
                       weights_only=True)

    def move(tree):
        if isinstance(tree, dict):
            return {k: v if k == "generator" else move(v)
                    for k, v in tree.items()}
        return tree.to(device) if isinstance(tree, torch.Tensor) else tree

    return move(state)
