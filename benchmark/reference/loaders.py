"""Plain reference of the phase-1 training loaders over an Ego4D-layout
feature tree: the AR, LTA and PNR train samples, each loader's seeded epoch
order and per-sample draws, and the zip of the three loaders into batch
groups.

It follows the published datasets (sapeirone/EgoPack:
``data/ego4d_fho.py``, AR windows :206-241, LTA windows :331-396;
``data/ego4d_oscc.py``, PNR :226-302; ``data/base_dataset.py``, segment
sampling :128-155) in the most direct form, sample by sample, and the
loader's documented order: a shuffle of the epoch's indices drawn from
``numpy.random.default_rng((seed, epoch, pass))``, whole batches only, and
each sample's draws from a Philox generator keyed by ``(mix, index)`` with
``mix = (seed * 1000003 + epoch) * 1000003 + pass`` (64 bits). It reads
the tree's json and ``.npy`` files with ``json`` and ``numpy`` only.
"""

from __future__ import annotations

import json
import math
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

MASK64 = 0xFFFFFFFFFFFFFFFF


class Tree:
    """An Ego4D-layout tree: annotations and per-video features."""

    def __init__(self, root: str, features: str, stride: int, fps: int):
        self.root, self.stride, self.fps = root, stride, fps
        self.ann = osp.join(root, "raw", "annotations", "v1")
        self.feat_dir = osp.join(root, "processed", "features", features)
        self._feats: Dict[str, np.ndarray] = {}

    def clips(self, name: str) -> list:
        with open(osp.join(self.ann, name)) as f:
            return json.load(f)["clips"]

    def features(self, video: str) -> np.ndarray:
        if video not in self._feats:
            self._feats[video] = np.load(
                osp.join(self.feat_dir, f"{video}.npy"), mmap_mode="r")
        return self._feats[video]


def segment_rows(sizes: np.ndarray, n: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Train sampling of ``n`` rows in each window (``base_dataset.py``):
    ``round(clip(j * size / n + U{0, size // n - 1}, 0, size))``, or the
    unjittered ``floor(j * size / n)`` where ``size // n`` is 0. The jitter
    of every window is one draw of shape ``(windows, n)``."""
    sizes = np.asarray(sizes, np.int64)
    base = np.arange(n)[None] * (sizes[:, None] / n)
    avg = sizes // n
    jitter = rng.integers(0, np.maximum(avg, 1)[:, None], size=(len(sizes), n))
    jittered = np.round(np.clip(base + jitter, 0, sizes[:, None]))
    return np.where(avg[:, None] > 0, jittered.astype(np.int64),
                    base.astype(np.int64))


def gather_windows(feats: np.ndarray, starts: np.ndarray, sizes: np.ndarray,
                   n: int, rng: np.random.Generator) -> np.ndarray:
    """``(windows, n, D)`` rows; a row past the video's end is its last row,
    and an empty window is zeros."""
    out = np.zeros((len(starts), n, feats.shape[1]), np.float32)
    rows = segment_rows(sizes, n, rng) + np.asarray(starts)[:, None]
    for w in range(len(starts)):
        if sizes[w] > 0:
            out[w] = feats[np.minimum(np.maximum(rows[w], 0),
                                      feats.shape[0] - 1)]
    return out


class _FHO:
    """The FHO train annotations, by clip, each clip's actions in order,
    and each action's feature window."""

    def __init__(self, tree: Tree, lta_start: bool):
        self.tree = tree
        by_clip: Dict[str, list] = {}
        for e in tree.clips("fho_lta_train.json"):
            by_clip.setdefault(e["clip_uid"], []).append(e)
        self.clips = {c: sorted(by_clip[c], key=lambda e: e["action_idx"])
                      for c in sorted(by_clip)}
        self.windows = {}
        for c, actions in self.clips.items():
            rows = tree.features(actions[0]["video_uid"]).shape[0]
            starts, sizes = [], []
            for e in actions:
                first = e["clip_parent_start_frame"]
                s = (first + e["action_clip_start_frame"]) // tree.stride
                if lta_start:
                    s = max(1, s) - 1
                end = min(rows - 1,
                          (first + e["action_clip_end_frame"]) // tree.stride)
                starts.append(s)
                sizes.append(end - s)
            self.windows[c] = (np.asarray(starts), np.asarray(sizes))


class RecognitionSamples(_FHO):
    """AR: a window of 9 actions around each action, labelled at its
    centre; windows past a clip's ends repeat its first or last action."""

    def __init__(self, tree: Tree, segments: int, window: int = 9):
        super().__init__(tree, lta_start=False)
        self.segments, self.window = segments, window
        self.items = []
        for c, actions in self.clips.items():
            for i in range(len(actions)):
                sel = [min(max(j, 0), len(actions) - 1)
                       for j in range(i - window // 2,
                                      i + window - window // 2)]
                self.items.append((c, sel))

    def __len__(self) -> int:
        return len(self.items)

    def get(self, idx: int, rng) -> Dict[str, np.ndarray]:
        c, sel = self.items[idx]
        actions = self.clips[c]
        centre = actions[sel[self.window // 2]]
        y = np.full((self.window, 2), -1, np.int32)
        y[self.window // 2] = (centre["verb_label"], centre["noun_label"])
        starts, sizes = self.windows[c]
        x = gather_windows(self.tree.features(actions[0]["video_uid"]),
                           starts[sel], sizes[sel], self.segments, rng)
        return {"x": x, "y": y}


class AnticipationSamples(_FHO):
    """LTA: 2 input actions and the 20 that follow as labels; the input
    clips alone are shipped (the forecast nodes are their mean, formed on
    the device)."""

    def __init__(self, tree: Tree, segments: int, inputs: int = 2,
                 forecast: int = 20):
        super().__init__(tree, lta_start=True)
        self.segments, self.inputs, self.forecast = segments, inputs, forecast
        self.items = [(c, i) for c, actions in self.clips.items()
                      for i in range(len(actions) - inputs - forecast)]

    def __len__(self) -> int:
        return len(self.items)

    def get(self, idx: int, rng) -> Dict[str, np.ndarray]:
        c, i = self.items[idx]
        actions = self.clips[c]
        n = self.inputs + self.forecast
        y = np.full((n, 2), -1, np.int32)
        for j, e in enumerate(actions[i + self.inputs:i + n]):
            y[self.inputs + j] = (e["verb_label"], e["noun_label"])
        starts, sizes = self.windows[c]
        sel = list(range(i, i + self.inputs))
        x = gather_windows(self.tree.features(actions[0]["video_uid"]),
                           starts[sel], sizes[sel], self.segments, rng)
        return {"x": x, "y": y}


class KeyframeSamples:
    """PNR: the state-change clips that have a keyframe; a random crop of
    5-8 s that keeps the keyframe, 16 evenly spaced frames whose features
    are interpolated between the two nearest feature rows, labelled one-hot
    at the frame nearest the keyframe."""

    def __init__(self, tree: Tree, segments: int = 16):
        self.tree, self.segments = tree, segments
        self.items = [e for e in tree.clips("fho_oscc-pnr_train.json")
                      if "state_change" in e
                      and e.get("parent_pnr_frame") is not None]

    def __len__(self) -> int:
        return len(self.items)

    def get(self, idx: int, rng) -> Dict[str, np.ndarray]:
        e = self.items[idx]
        feats = self.tree.features(e["video_uid"])
        fps, stride = self.tree.fps, self.tree.stride
        pnr = float(e["parent_pnr_frame"])
        start_sec, end_sec = float(e["parent_start_sec"]), float(
            e["parent_end_sec"])
        length = rng.uniform(5, 8)
        # the published offset: numpy's uniform(8 - length) with its default
        # high of 1, a draw between 8 - length and 1
        low = 8.0 - length
        crop_start = start_sec + low + (1.0 - low) * rng.random()
        first = int(math.floor(crop_start * fps))
        crop_end = min(crop_start + length, end_sec)
        last = int(math.floor(crop_end * fps))
        if pnr > last:
            last = e["parent_end_frame"]
        if pnr < first:
            first = e["parent_start_frame"]
        frames = np.linspace(first, last, num=self.segments, dtype=int,
                             endpoint=False)
        frames = np.clip(frames, first, last)
        top = feats.shape[0] - 1
        x = np.empty((self.segments, feats.shape[1]), np.float32)
        for j, f in enumerate(frames):
            lo = min(max(math.floor(f / stride), 0), top)
            hi = min(max(math.ceil(f / stride), 0), top)
            w = np.float32((f % stride) / stride)
            if lo == hi:
                x[j] = feats[lo]
            else:
                x[j] = (np.float32(1) - w) * feats[lo] + w * feats[hi]
        y = np.zeros(self.segments, np.int32)
        y[int(np.abs(frames - pnr).argmin())] = 1
        return {"x": x, "y": y}


def loader_batches(samples, batch_size: int, seed: int, epoch: int,
                   count: int, pass_idx: int = 0) -> List[Dict[str, np.ndarray]]:
    """The first ``count`` whole batches of a loader's pass."""
    order = np.arange(len(samples))
    np.random.default_rng((seed, epoch, pass_idx)).shuffle(order)
    mix = ((seed * 1000003 + epoch) * 1000003 + pass_idx) & MASK64
    out = []
    for b in range(count):
        idxs = order[b * batch_size:(b + 1) * batch_size]
        got = [samples.get(int(i), np.random.Generator(
            np.random.Philox(key=[mix, int(i)]))) for i in idxs]
        out.append({"x": np.stack([g["x"] for g in got]),
                    "y": np.stack([g["y"] for g in got]),
                    "valid": np.ones(len(got), bool)})
    return out


SAMPLES = {"ar": RecognitionSamples, "lta": AnticipationSamples,
           "pnr": KeyframeSamples}


def first_groups(tree: Tree, tasks, segments: Dict[str, int],
                 batch_size: int, seed: int, epoch: int, count: int,
                 samples: Optional[dict] = None) -> List[Dict[str, dict]]:
    """The first ``count`` batch groups of an epoch: one batch a task, the
    tasks' loaders zipped."""
    per_task = {}
    for t in tasks:
        s = SAMPLES[t](tree, segments[t])
        if len(s) < count * batch_size:
            raise ValueError(f"{t}: {len(s)} samples, under {count} batches")
        per_task[t] = loader_batches(s, batch_size, seed, epoch, count)
    return [{t: per_task[t][g] for t in tasks} for g in range(count)]
