"""Ego4D FHO datasets: Action Recognition (AR), Long-Term Anticipation (LTA)
and Anticipation — dense, fixed-shape samples (the port's copy of
``egopack_tpu/data/fho.py``).

Annotation schema and sampling semantics mirror
reference data/ego4d_fho.py (AR window logic :206-241, LTA window logic
:331-396, Anticipation :245-308); shapes are the dense layout:

- AR sample: ``x (9, S, D)``, ``y (9, 2)`` with −1 everywhere but the center
- LTA sample: ``x (22, S, D)``, ``y (22, 2)`` with −1 on the 2 input clips
- Anticipation: ``x (A, S, D)``, ``y (A, 2)`` labeled on the last node
"""

from __future__ import annotations

import logging
import os.path as osp
from collections import namedtuple
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import sampling
from ..io import native
from .base import BaseDataset, FeatureStore, load_json
from .ego4d import FEATURE_SIZES, FEATURE_STRIDES
from .graphs import GraphSpec, ar_spec, lta_spec

logger = logging.getLogger(__name__)

FHOEntry = namedtuple("FHOEntry", ["id", "video_uid", "clip_uid",
                                   "start_frame", "end_frame",
                                   "verb_label", "noun_label"])
# sel: (window,) indices into the clip's precomputed action-window arrays
AREntry = namedtuple("AREntry", ["video_uid", "clip_uid", "sel",
                                 "verb", "noun"])
LTAEntry = namedtuple("LTAEntry", ["video_uid", "clip_uid", "id",
                                   "input_sel", "forecast_labels"])

_EGOVLP_BROKEN_VIDEOS = (
    "77ed1624-f87b-4196-9a0a-95b7023b18e4",
    "d18ef16d-f803-4387-bb5e-7876f1522a63",
    "8e914832-2dd1-44fd-81f8-1b7e2ccd2402",
)


class Ego4dFHODataset(BaseDataset):
    """Shared FHO annotation parsing (reference: data/ego4d_fho.py:33-174)."""

    def __init__(self, split: str, root: str = "data/ego4d",
                 features: str = "omnivore_video_swinl", version: int = 1,
                 num_segments: int = 3, verbose: bool = True):
        self.split = split.replace("validation", "val")
        self.root = root
        self.version = version
        self.features_path = features
        self.num_segments = num_segments
        self.verbose = verbose
        self.stride = FEATURE_STRIDES[features]

        ann_path = osp.join(root, "raw", f"annotations/v{version}",
                            f"fho_lta_{self.split}.json")
        raw = load_json(ann_path, f"FHO annotations for split {self.split}")
        self.annotations = [
            FHOEntry(e["action_idx"], e["video_uid"], e["clip_uid"],
                     e["clip_parent_start_frame"] + e["action_clip_start_frame"],
                     e["clip_parent_start_frame"] + e["action_clip_end_frame"],
                     e.get("verb_label"), e.get("noun_label"))
            for e in raw["clips"]
        ]
        if "egovlp" in features:
            self.annotations = [e for e in self.annotations
                                if e.video_uid not in _EGOVLP_BROKEN_VIDEOS]

        self.video_uids = sorted({e.video_uid for e in self.annotations})
        self.clip_uids = sorted({e.clip_uid for e in self.annotations})

        tax_path = osp.join(root, "raw", f"annotations/v{version}",
                            "fho_lta_taxonomy.json")
        self.taxonomy = load_json(tax_path, "FHO taxonomy")

        self._store = FeatureStore(root, features, self.video_uids,
                                   f"fho_{self.split}_v{version}.csv")

    # --- taxonomy protocol ---
    @property
    def label_names(self) -> Tuple[str, ...]:
        return ("verbs", "nouns")

    @property
    def class_labels(self) -> Tuple[List[str], ...]:
        return tuple(self.taxonomy[name] for name in self.label_names)

    @property
    def features_size(self) -> int:
        try:
            return self._store.feature_dim
        except StopIteration:
            return FEATURE_SIZES[self.features_path]

    # --- vectorized window precompute (host hot path) ---
    def _clip_windows(self, actions, lta_start_rule: bool = False):
        """Per-clip ``(a_start, size)`` int64 arrays for a sorted action list.

        AR start rule: ``start_frame // stride`` (reference :230); LTA start
        rule: ``max(1, start_frame // stride) - 1`` (reference :369); both end
        at ``min(len - 1, end_frame // stride)``. Hoisted to dataset init so ``get()`` does ONE vectorized
        sampler + ONE native gather per sample instead of one per action —
        the per-action Python dispatch was the host bottleneck at Ego4D
        scale (scripts/bench_host_pipeline.py)."""
        n_rows = self._store[actions[0].video_uid].shape[0]
        sf = np.asarray([a.start_frame for a in actions], np.int64)
        ef = np.asarray([a.end_frame for a in actions], np.int64)
        if lta_start_rule:
            a_start = np.maximum(1, sf // self.stride) - 1
        else:
            a_start = sf // self.stride
        a_end = np.minimum(n_rows - 1, ef // self.stride)
        return a_start, a_end - a_start

    def _gather_windows(self, video_uid: str, starts, sizes,
                        rng: Optional[np.random.Generator]) -> np.ndarray:
        """(A, S, D) features for A windows in one video: one vectorized
        sampler + one (multithreaded) native gather. Empty windows (size<=0)
        zero-fill via the gather's negative-index guard — the reference's
        silent-corruption behavior (:238-239)."""
        feats = self._store[video_uid]
        idx = sampling.batch_sampling_indices(sizes, self.num_segments, rng)
        flat = np.where(sizes[:, None] > 0, idx + starts[:, None], -1)
        out = native.gather_rows(feats, flat.reshape(-1))
        return out.reshape(len(starts), self.num_segments, feats.shape[1])


class Ego4dRecognitionDataset(Ego4dFHODataset):
    """AR: sliding window of ``window_size`` actions, labels at the center only.

    Reference: reference data/ego4d_fho.py:177-241.
    """

    def __init__(self, split: str, num_segments: int = 3, root: str = "data/ego4d",
                 features: str = "omnivore_video_swinl", version: int = 1,
                 window_size: int = 9, randomize_train: bool = True,
                 verbose: bool = True, transform=None):
        super().__init__(split, root, features, version, num_segments, verbose)
        del transform  # graph construction is static (data/graphs.py)
        self.window_size = window_size
        self.randomize_train = randomize_train

        clip_annotations = {
            cu: sorted([e for e in self.annotations if e.clip_uid == cu],
                       key=lambda x: x.id)
            for cu in self.clip_uids
        }
        # per-clip (a_start, size) arrays, indexed by each window's sel
        self._windows = {cu: self._clip_windows(actions)
                         for cu, actions in clip_annotations.items()}
        self.action_segments: List[AREntry] = []
        for clip_uid, actions in clip_annotations.items():
            video_uid = actions[0].video_uid
            for i in range(len(actions)):
                left = i - (window_size // 2)
                right = i + (window_size - window_size // 2)
                sel = [0] * max(0, -left)
                sel += list(range(max(0, left), min(len(actions), right)))
                sel += [len(actions) - 1] * max(0, right - len(actions))
                center = actions[i]
                self.action_segments.append(
                    AREntry(video_uid, clip_uid, np.asarray(sel, np.int64),
                            center.verb_label, center.noun_label))

    def graph_spec(self, k: float = 1.0) -> GraphSpec:
        return ar_spec(self.window_size, k)

    def __len__(self) -> int:
        return len(self.action_segments)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        seg = self.action_segments[idx]
        center = self.window_size // 2
        y = np.full((self.window_size, 2), -1, dtype=np.int32)
        y[center, 0] = seg.verb
        y[center, 1] = seg.noun
        use_rng = rng if (self.split == "train" and self.randomize_train) else None
        starts, sizes = self._windows[seg.clip_uid]
        x = self._gather_windows(seg.video_uid, starts[seg.sel],
                                 sizes[seg.sel], use_rng)
        return {"x": x, "y": y}


class Ego4dLTADataset(Ego4dFHODataset):
    """LTA: 2 input clips + 20 forecast nodes (features = mean of inputs).

    Reference: reference data/ego4d_fho.py:311-396.
    """

    def __init__(self, split: str, num_segments: int = 3, num_input_clips: int = 2,
                 num_forecasted_clips: int = 20, append_node: str = "avg",
                 root: str = "data/ego4d", features: str = "omnivore_video_swinl",
                 version: int = 1, verbose: bool = True, transform=None):
        super().__init__(split, root, features, version, num_segments, verbose)
        del transform
        self.n_input_clips = num_input_clips
        self.n_forecast_clips = num_forecasted_clips
        self.append_node = append_node

        clip_annotations = {
            cu: sorted([e for e in self.annotations if e.clip_uid == cu],
                       key=lambda x: x.id)
            for cu in self.clip_uids
        }
        self._windows = {cu: self._clip_windows(actions, lta_start_rule=True)
                         for cu, actions in clip_annotations.items()}
        self.lta_annotations: List[LTAEntry] = []
        for clip_uid, videos in clip_annotations.items():
            video_uid = videos[0].video_uid
            if "test" in split:
                for i in range(len(videos) - num_input_clips):
                    inp_sel = np.arange(i, i + num_input_clips)
                    self.lta_annotations.append(
                        LTAEntry(video_uid, clip_uid,
                                 videos[i + num_input_clips - 1].id,
                                 inp_sel, None))
            else:
                for i in range(len(videos) - num_input_clips - num_forecasted_clips):
                    inp_sel = np.arange(i, i + num_input_clips)
                    fore = videos[i + num_input_clips:
                                  i + num_input_clips + num_forecasted_clips]
                    labels = np.asarray([(c.verb_label, c.noun_label)
                                         for c in fore], np.int32)
                    self.lta_annotations.append(
                        LTAEntry(video_uid, clip_uid,
                                 videos[i + num_input_clips - 1].id,
                                 inp_sel, labels))

    def graph_spec(self, k: float = 1.0) -> GraphSpec:
        return lta_spec(self.n_input_clips, self.n_forecast_clips, k)

    def __len__(self) -> int:
        return len(self.lta_annotations)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        ann = self.lta_annotations[idx]
        n = self.n_input_clips + self.n_forecast_clips
        y = np.full((n, 2), -1, dtype=np.int32)
        if "test" in self.split:
            y[self.n_input_clips:, :] = 0
        else:
            y[self.n_input_clips:] = ann.forecast_labels

        use_rng = rng if self.split == "train" else None
        starts, sizes = self._windows[ann.clip_uid]
        inputs = self._gather_windows(ann.video_uid, starts[ann.input_sel],
                                      sizes[ann.input_sel], use_rng)
        if self.append_node == "random":
            # host rng fill is not reproducible on device: keep the full
            # layout (reference reference data/ego4d_fho.py:384-391)
            gen = rng or np.random.default_rng(0)
            x = np.empty((n,) + inputs.shape[1:], np.float32)
            x[:self.n_input_clips] = inputs
            x[self.n_input_clips:] = gen.random(
                (self.n_forecast_clips,) + inputs.shape[1:], np.float32)
        else:  # avg (reference default) / zero: the forecast nodes are a
            # deterministic function of the inputs — ship COMPACT and let the
            # train step broadcast them on the device
            # (MultiTaskSystem.expand_x), deleting the dominant host memcpy
            # and ~10× of this task's H2D bytes
            x = inputs
        return {"x": x, "y": y, "clip_uid": ann.clip_uid, "last_idx": ann.id}


class Ego4dAnticipationDataset(Ego4dFHODataset):
    """Short-term anticipation over pre-action seconds.

    Reference: reference data/ego4d_fho.py:245-308 (not used by the two
    mains, kept for capability parity).
    """

    def __init__(self, split: str, num_segments: int = 3, root: str = "data/ego4d",
                 features: str = "omnivore_video_swinl",
                 anticipation_secs: int = 7, blackout_secs: int = 1,
                 append_node: Optional[str] = None, version: int = 1,
                 verbose: bool = True, transform=None):
        super().__init__(split, root, features, version, num_segments, verbose)
        del transform
        self.anticipation_secs = anticipation_secs
        self.blackout_secs = blackout_secs
        self.append_node = append_node

    @property
    def num_nodes(self) -> int:
        n = self.anticipation_secs - self.blackout_secs
        return n + (1 if self.append_node is not None else 0)

    def graph_spec(self, k: float = 1.0) -> GraphSpec:
        from .graphs import GraphSpec as _GS, radius_adjacency
        pos = np.arange(self.num_nodes, dtype=np.float32)
        return _GS("ant", self.num_nodes, pos,
                   radius_adjacency(pos, k + 0.5), radius=k + 0.5)

    def __len__(self) -> int:
        return len(self.annotations)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        """Vectorized: ONE batched sampler + ONE native gather over all
        pre-action second-windows (the same host hot path as the other four
        loaders — per-second windows ``[max(1, (sf+sec·30)//stride)-1,
        max(1, (sf+(1+sec)·30)//stride))``, reference
        reference data/ego4d_fho.py:277-296; out-of-range/empty windows
        zero-fill like the reference's try/except guard)."""
        action = self.annotations[idx]
        feats = self._store[action.video_uid]
        n_rows = feats.shape[0]
        secs = np.arange(-self.anticipation_secs, -self.blackout_secs,
                         dtype=np.int64)
        starts = np.maximum(1, (action.start_frame + secs * 30)
                            // self.stride) - 1
        ends = np.maximum(1, (action.start_frame + (secs + 1) * 30)
                          // self.stride)
        starts = np.minimum(starts, n_rows)
        sizes = np.maximum(np.minimum(ends, n_rows) - starts, 0)
        train_rng = rng if (self.split == "train" and rng is not None) else None
        x = self._gather_windows(action.video_uid, starts, sizes, train_rng)
        y = np.full((self.num_nodes, 2), -1, dtype=np.int32)
        if self.append_node is not None:
            if self.append_node == "random":
                gen = rng or np.random.default_rng(0)
                extra = gen.random(x.shape[1:]).astype(np.float32)
            elif self.append_node == "zero":
                extra = np.zeros(x.shape[1:], np.float32)
            else:
                extra = x.mean(0)
            x = np.concatenate([x, extra[None]], axis=0)
        y[-1] = (action.verb_label, action.noun_label)
        return {"x": x, "y": y}
