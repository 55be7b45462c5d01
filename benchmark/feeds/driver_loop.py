"""Feed ``driver_loop``: the phase-1 driver's training loop as
``egopack_torch/train/driver.py:_run_epochs`` composes it. An Ego4D-layout
tree (annotations and per-video feature files) is written at set-up from
the seed by the program's ``data/synthetic.py:generate_ego4d_fixture``,
under ``TMPDIR``; the program's train datasets of the configuration's tasks
read it through their loaders (``build_dataloader`` as ``build_datasets``
calls it, ``loader_processes`` 0), which ``MultiLoader`` zips and
``device_prefetch`` with a ``DeviceCopier`` hands to the card, two groups
ahead. A new epoch starts when the window outruns one.

The traffic mix gives the tree's size (``videos``, ``actions_per_clip``,
``oscc_clips``), the feature extractor's name, row stride and frame rate,
and the loaders' prefetch depth (``num_workers``). The tree stays until
the reference has read it (``reference_groups``), or until the process
ends.
"""

from __future__ import annotations

import atexit
import shutil
import tempfile
from typing import Dict, List

import torch

TASK_ORDER = ("ar", "oscc", "lta", "pnr")  # the driver's loader order
PNR_FRAMES = 16  # the published PNR dataset's frames a clip
EPOCH = 1  # the driver's first epoch

_TREES: Dict[tuple, str] = {}


def _remove_trees() -> None:
    for root in _TREES.values():
        shutil.rmtree(root, ignore_errors=True)
    _TREES.clear()


atexit.register(_remove_trees)


def tree(cfg: dict, traffic: dict, seed: int) -> str:
    """The tree of ``seed``, written once per process."""
    key = (seed, cfg["feature_dim"], cfg["n_verbs"], cfg["n_nouns"])
    if key not in _TREES:
        from egopack_torch.data.synthetic import generate_ego4d_fixture
        root = tempfile.mkdtemp(prefix="egopack-bench-tree-")
        generate_ego4d_fixture(
            root, features=traffic["features"],
            feature_dim=cfg["feature_dim"], n_videos=traffic["videos"],
            actions_per_clip=traffic["actions_per_clip"],
            n_verbs=cfg["n_verbs"], n_nouns=cfg["n_nouns"],
            n_oscc=traffic["oscc_clips"], splits=("train",), seed=seed)
        _TREES[key] = root
    return _TREES[key]


def segments(cfg: dict) -> Dict[str, int]:
    """Segments (rows) a node of each task's samples."""
    return {"ar": cfg["num_segments"], "lta": cfg["num_segments"],
            "pnr": PNR_FRAMES}


class DriverLoop:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from egopack_torch.data import fho, osccpnr
        from egopack_torch.data import loader as L
        self._L = L
        root = tree(cfg, traffic, seed)
        common = dict(split="train", root=root, features=traffic["features"],
                      verbose=False)
        seg = segments(cfg)
        datasets = {
            "ar": lambda: fho.Ego4dRecognitionDataset(
                num_segments=seg["ar"], **common),
            "lta": lambda: fho.Ego4dLTADataset(
                num_segments=seg["lta"],
                num_input_clips=cfg["lta_input_clips"],
                num_forecasted_clips=(cfg["nodes"]["lta"]
                                      - cfg["lta_input_clips"]),
                append_node="avg", **common),
            "pnr": lambda: osccpnr.Ego4dPNRDataset(num_segments=seg["pnr"],
                                                   **common),
        }
        self.active = tuple(cfg["tasks"])
        self.loaders = [
            L.build_dataloader(datasets[t](), cfg["batch_size"], True,
                               traffic["num_workers"], True, seed=seed)
            if t in self.active else None for t in TASK_ORDER]
        self.copier = L.DeviceCopier(device, None)
        self.epoch = EPOCH
        self._start()

    def _start(self) -> None:
        for dl in self.loaders:
            if dl is not None:
                dl.set_epoch(self.epoch)
        self._zip = iter(self._L.MultiLoader(
            self.loaders, [1.0 if dl is not None else 0.0
                           for dl in self.loaders]))
        self._groups = self._L.device_prefetch(self._zip, self._put,
                                               self._ready)

    def _put(self, group):
        """Start the copies of a group; count its valid samples on the
        host."""
        batches = {t: b for t, b in zip(TASK_ORDER, group)
                   if t in self.active}
        clips = sum(int(b["valid"].sum()) for b in batches.values())
        return {t: self.copier.put(b) for t, b in batches.items()}, clips

    def _ready(self, item):
        batches, clips = item
        return self.copier.ready(batches), clips

    def next(self):
        """The next group and the clips it trains."""
        item = next(self._groups, None)
        if item is None:  # the epoch is over: the next one
            self.epoch += 1
            self._start()
            item = next(self._groups)
        return item

    def close(self) -> None:
        """Stop the loaders' threads (the tree stays for the reference)."""
        self._groups.close()
        self._zip.close()
        self.loaders = []


def make(cfg: dict, traffic: dict, seed: int,
         device: torch.device) -> DriverLoop:
    return DriverLoop(cfg, traffic, seed, device)


def reference_groups(cfg: dict, traffic: dict, seed: int,
                     device: torch.device, n: int) -> List[Dict]:
    """The first ``n`` groups, made by the plain reference of the loaders
    (``benchmark/reference/loaders.py``) from the same tree, which it then
    removes."""
    from benchmark.reference import loaders as ref
    root = tree(cfg, traffic, seed)
    t = ref.Tree(root, traffic["features"], traffic["feature_stride"],
                 traffic["fps"])
    groups = ref.first_groups(t, cfg["tasks"], segments(cfg),
                              cfg["batch_size"], seed, EPOCH, n)
    _remove_trees()
    return [{task: {k: torch.from_numpy(v).to(device) for k, v in b.items()}
             for task, b in g.items()} for g in groups]
