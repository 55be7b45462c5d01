"""Dataset base: annotation parsing + memmapped feature store (the port's
copy of ``egopack_tpu/data/base.py``).

Mirrors the protocol of reference data/base_dataset.py:8-123 (label
taxonomy surface) and the memmap/process machinery of
reference data/ego4d_fho.py:97-174. Samples are returned as dense numpy
dicts with *fixed* per-task shapes so the device pipeline sees static shapes
only — the PyG variable-node Batch of the reference is deliberately gone.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


class BaseDataset:
    """Common label/taxonomy protocol (reference: data/base_dataset.py:24-123)."""

    @property
    def num_labels(self) -> int:
        return len(self.label_names)

    @property
    def label_names(self) -> Tuple[str, ...]:
        raise NotImplementedError

    @property
    def has_joint_label(self) -> bool:
        return False

    @property
    def class_labels(self) -> Tuple[List[str], ...]:
        raise NotImplementedError

    @property
    def num_class_labels(self) -> Tuple[int, ...]:
        return tuple(len(labels) for labels in self.class_labels)

    @property
    def features_size(self) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class FeatureStore:
    """Memmapped per-video features with one-time .pt→.npy conversion.

    Reference behavior (reference data/ego4d_fho.py:142-174): raw
    features live at ``<root>/raw/features/<backbone>/<uid>.pt``; ``process()``
    converts each to ``<root>/processed/features/<backbone>/<uid>.npy`` once and
    writes a metadata csv; loading memmaps every video referenced by the split.
    """

    def __init__(self, root: str, features: str, video_uids: List[str],
                 metadata_name: str):
        self.root = root
        self.features = features
        self.video_uids = video_uids
        self.metadata_name = metadata_name
        self.raw_dir = osp.join(root, "raw", "features", features)
        self.processed_dir = osp.join(root, "processed", "features", features)
        self.process()
        self._features = {
            uid: np.load(osp.join(self.processed_dir, f"{uid}.npy"), mmap_mode="r")
            for uid in video_uids
        }

    def process(self) -> None:
        csv_path = osp.join(self.processed_dir, self.metadata_name)
        missing = [uid for uid in self.video_uids
                   if not osp.exists(osp.join(self.processed_dir, f"{uid}.npy"))]
        if not missing and osp.exists(csv_path):
            return
        os.makedirs(self.processed_dir, exist_ok=True)
        for uid in missing:
            pt_path = osp.join(self.raw_dir, f"{uid}.pt")
            if not osp.exists(pt_path):
                logger.warning("Could not find features for video %s in %s",
                               uid, self.raw_dir)
                continue
            feats = torch.load(pt_path, map_location="cpu")
            arr = np.asarray(feats.numpy(), dtype=np.float32)
            np.save(osp.join(self.processed_dir, f"{uid}.npy"), arr)
        # the metadata csv covers EVERY converted video of this split —
        # datasets share the processed dir, so videos converted earlier by a
        # sibling dataset must not vanish from this split's csv (the
        # reference writes the full frame each time, ego4d_fho.py:162-168)
        rows = []
        for uid in self.video_uids:
            p = osp.join(self.processed_dir, f"{uid}.npy")
            if osp.exists(p):
                arr = np.load(p, mmap_mode="r")
                rows.append((uid, arr.shape[0], arr.shape[1]))
        if rows:
            with open(csv_path, "w") as f:
                f.write("video_uid,length,features_size\n")
                for uid, length, size in rows:
                    f.write(f"{uid},{length},{size}\n")

    def __getstate__(self) -> dict:
        # a memmap pickles as a copy of its whole array: a spawned loader
        # worker would get every video in memory. Pickle the paths instead.
        state = dict(self.__dict__)
        state["_features"] = list(self._features)
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._features = {
            uid: np.load(osp.join(self.processed_dir, f"{uid}.npy"),
                         mmap_mode="r")
            for uid in state["_features"]}

    def __getitem__(self, uid: str) -> np.ndarray:
        return self._features[uid]

    @property
    def feature_dim(self) -> int:
        """Actual feature dimension from the arrays (authoritative over the
        registry — lets tests/benchmarks use any dim)."""
        first = next(iter(self._features.values()))
        return int(first.shape[1])


def load_json(path: str, what: str) -> dict:
    if not osp.exists(path):
        raise FileNotFoundError(f"Could not find the {what} at {path}")
    with open(path, "r") as f:
        return json.load(f)
