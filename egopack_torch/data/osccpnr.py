"""Ego4D OSCC (object state change classification) and PNR (point of no
return) datasets — dense, fixed-shape samples (the port's copy of
``egopack_tpu/data/osccpnr.py``).

Semantics mirror reference data/ego4d_oscc.py (OSCC sampling :191-223,
PNR crop + interpolation :238-302); shapes are the dense layout:

- OSCC sample: ``x (4, S, D)`` (4 graph nodes of S segments), ``y ()`` in {0,1}
- PNR sample: ``x (16, 3, D)`` (each frame feature repeated 3×, reference
  :291), ``y (16,)`` one-hot at the frame nearest the PNR, plus localization
  metadata for the meter
"""

from __future__ import annotations

import logging
import os.path as osp
from collections import namedtuple
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io import native
from .base import BaseDataset, FeatureStore, load_json
from .ego4d import FEATURE_SIZES, FEATURE_STRIDES, FPS
from .graphs import GraphSpec, oscc_spec, pnr_spec

logger = logging.getLogger(__name__)

OSCCPNREntry = namedtuple("OSCCPNREntry", [
    "video_uid", "unique_uid", "start_frame", "end_frame",
    "start_sec", "end_sec", "state_change", "pnr_frame",
])


class Ego4dOSCCDataset(BaseDataset):
    """OSCC: 4-node graph of (end-start)/stride feature rows, binary label.

    Reference: reference data/ego4d_oscc.py:43-223.
    """

    def __init__(self, split: str, num_segments: int = 3, root: str = "data/ego4d",
                 features: str = "omnivore_video_swinl", version: int = 1,
                 aug_prob: float = 0.1, remove_overlapping_segments: bool = False,
                 verbose: bool = True, transform=None):
        del transform
        self.split = split.replace("validation", "val")
        self.root = root
        self.version = version
        self.features_path = features
        self.num_segments = num_segments
        self.aug_prob = aug_prob
        self.verbose = verbose
        self.stride = FEATURE_STRIDES[features]

        ann_path = osp.join(root, "raw", f"annotations/v{version}",
                            f"fho_oscc-pnr_{self.split}.json")
        raw = load_json(ann_path, f"OSCC annotations for split {self.split}")
        clips = raw["clips"]

        if self.split == "train" and remove_overlapping_segments:
            clips = self._remove_overlapping(clips)

        def _pnr(e):
            if "state_change" not in e:
                return None
            pf = e.get("parent_pnr_frame")
            return float(pf) if pf is not None else None

        self.annotations = [
            OSCCPNREntry(e["video_uid"], e["unique_id"],
                         e["parent_start_frame"], e["parent_end_frame"],
                         float(e["parent_start_sec"]), float(e["parent_end_sec"]),
                         int(e["state_change"]) if "state_change" in e else -1,
                         _pnr(e))
            for e in clips
        ]
        self.video_uids = sorted({e.video_uid for e in self.annotations})
        self._store = FeatureStore(root, features, self.video_uids,
                                   f"oscc_{self.split}_v{version}.csv")
        if verbose:
            logger.info("Ego4D OSCC %s: %d samples", self.split, len(self))

    @staticmethod
    def _remove_overlapping(clips: List[dict]) -> List[dict]:
        """Drop train segments where a positive and negative interval of the
        same video overlap (reference :81-98)."""
        pos = [c for c in clips if c.get("parent_pnr_frame") is not None]
        neg = [c for c in clips if c.get("parent_pnr_frame") is None]
        by_video: Dict[str, List[dict]] = {}
        for c in neg:
            by_video.setdefault(c["video_uid"], []).append(c)
        bad = set()
        for p in pos:
            for n in by_video.get(p["video_uid"], ()):  # closed intervals
                if (p["parent_start_sec"] <= n["parent_end_sec"]
                        and n["parent_start_sec"] <= p["parent_end_sec"]):
                    bad.add(p["unique_id"])
                    bad.add(n["unique_id"])
        return [c for c in clips if c["unique_id"] not in bad]

    @property
    def label_names(self) -> Tuple[str, ...]:
        return ("state_change",)

    @property
    def class_labels(self) -> Tuple[List[str], ...]:
        return (["no_change", "change"],)

    @property
    def features_size(self) -> int:
        try:
            return self._store.feature_dim
        except StopIteration:
            return FEATURE_SIZES[self.features_path]

    def graph_spec(self, k: float = 1.0) -> GraphSpec:
        return oscc_spec(k)

    def __len__(self) -> int:
        return len(self.annotations)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        seg = self.annotations[idx]
        feats = self._store[seg.video_uid]
        state_change = seg.state_change

        start_frame = seg.start_frame - (seg.start_frame % self.stride)
        end_frame = seg.end_frame - (seg.end_frame % self.stride)
        n_rows = (end_frame - start_frame) // self.stride

        if self.split == "train" and rng is not None:
            selected = rng.choice(n_rows, size=4 * self.num_segments,
                                  replace=(n_rows < 4 * self.num_segments))
        else:
            selected = np.linspace(0, n_rows, num=4 * self.num_segments,
                                   endpoint=False, dtype=int)
        selected = np.sort(selected)

        # reference zero-guard: np.take raises iff any selected index falls
        # outside the (possibly file-truncated) window (data/ego4d_oscc.py:208)
        s_row = start_frame // self.stride
        window_len = max(0, min(feats.shape[0], end_frame // self.stride) - s_row)
        if len(selected) == 0 or selected.max() >= window_len:
            graph = np.zeros((len(selected), feats.shape[1]), np.float32)
        else:
            graph = native.gather_rows(feats, selected + s_row)
        graph = graph.reshape(4, self.num_segments, -1)

        # PNR-truncation augmentation: repeat the last pre-PNR node and flip
        # the label to 0 (reference :214-221; its array/list concat there is
        # broken and dead behind aug_prob=0 — this is the intended node-level
        # semantics, documented in SURVEY.md §2.1)
        if (self.split == "train" and state_change == 1 and rng is not None
                and rng.random() < self.aug_prob and seg.pnr_frame is not None):
            node_start_frames = start_frame + selected[::self.num_segments] * self.stride
            pre_pnr = node_start_frames < seg.pnr_frame
            pnr_node = int(pre_pnr.nonzero()[0].max()) if pre_pnr.any() else 0
            if pnr_node > 0:
                graph[pnr_node:] = graph[pnr_node - 1]
            else:
                graph[0] = graph[1]
            state_change = 0

        return {"x": graph, "y": np.int32(state_change), "uid": seg.unique_uid}


class Ego4dPNRDataset(Ego4dOSCCDataset):
    """PNR keyframe localization: 16 nodes with fractional-stride interpolation.

    Reference: reference data/ego4d_oscc.py:226-302.
    """

    def __init__(self, split: str, num_segments: int = 16, root: str = "data/ego4d",
                 features: str = "omnivore_video_swinl", version: int = 1,
                 verbose: bool = True, transform=None):
        super().__init__(split, num_segments, root, features, version,
                         verbose=verbose, transform=transform)
        if "test" not in self.split:
            self.annotations = [e for e in self.annotations
                                if e.pnr_frame is not None]

    @property
    def label_names(self) -> Tuple[str, ...]:
        return ("pnr",)

    @property
    def class_labels(self) -> Tuple[List[str], ...]:
        return (["bg", "pnr"],)

    def graph_spec(self, k: float = 1.0) -> GraphSpec:
        return pnr_spec(self.num_segments, k)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        seg = self.annotations[idx]
        feats = self._store[seg.video_uid]
        pnr_frame = seg.pnr_frame
        start_frame, end_frame = seg.start_frame, seg.end_frame

        if self.split == "train" and rng is not None:
            random_len = rng.uniform(5, 8)
            # reference quirk (load-bearing): np.random.uniform(8 - len) is a
            # single POSITIONAL low with high=1.0 (ego4d_oscc.py:248), i.e.
            # offset = (8-len) + (1-(8-len))*u — a draw BETWEEN 8-len and 1.0
            # (in either order; numpy doesn't validate low>high) — NOT
            # uniform(0, 8-len)
            lo = 8.0 - random_len
            random_start = seg.start_sec + lo + (1.0 - lo) * rng.random()
            start_frame = int(np.floor(random_start * FPS))
            random_end = random_start + random_len
            if random_end > seg.end_sec:
                random_end = seg.end_sec
            end_frame = int(np.floor(random_end * FPS))
            if seg.pnr_frame is not None and seg.pnr_frame > end_frame:
                end_frame = seg.end_frame
            if seg.pnr_frame is not None and seg.pnr_frame < start_frame:
                start_frame = seg.start_frame

        candidates = np.linspace(start_frame, end_frame, num=self.num_segments,
                                 dtype=int, endpoint=False)
        candidates = np.clip(candidates, start_frame, end_frame)

        lo = np.clip(np.floor(candidates / self.stride).astype(int), 0,
                     feats.shape[0] - 1)
        hi = np.clip(np.ceil(candidates / self.stride).astype(int), 0,
                     feats.shape[0] - 1)
        frac = ((candidates % self.stride) / self.stride).astype(np.float32)
        x = native.gather_interp(feats, lo, hi, frac)

        if "test" not in self.split:
            distances = np.abs(candidates - pnr_frame)
            y = np.zeros(self.num_segments, dtype=np.int32)
            y[int(distances.argmin())] = 1
        else:
            y = np.full(self.num_segments, -1, dtype=np.int32)

        # nodes carry the frame feature repeated 3× (reference :291) so the
        # TRN pooling sees the standard (N, 3, D) layout — the repeat happens
        # ON DEVICE (MultiTaskSystem.expand_x); shipping (N, D) compact cuts
        # this task's H2D bytes 3×
        return {
            "x": x, "y": y, "uid": seg.unique_uid,
            "start_frame": np.float32(start_frame),
            "end_frame": np.float32(end_frame),
            "pnr_frame": np.float32(pnr_frame if pnr_frame is not None else -1.0),
        }
