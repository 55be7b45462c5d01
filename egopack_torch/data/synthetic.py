"""Synthetic Ego4D fixture generator (the port's copy of
``egopack_tpu/data/synthetic.py``: the same files from the same seed).

Produces annotation JSONs and feature arrays in exactly the on-disk schema the
real pipeline consumes (fho_lta_{split}.json fields per
reference data/ego4d_fho.py:60-67, fho_oscc-pnr_{split}.json fields per
reference data/ego4d_oscc.py:75-108), so every layer from dataset parsing
to the two-phase trainers runs hermetically. The reference repo has no test
fixtures at all (SURVEY.md §4) — this generator is what makes the rebuilt
framework testable and benchmarkable without the 600GB Ego4D release.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from .ego4d import FEATURE_STRIDES, FPS


def generate_ego4d_fixture(root: str,
                           features: str = "omnivore_video_swinl",
                           feature_dim: int = 64,
                           n_videos: int = 2,
                           actions_per_clip: int = 30,
                           n_verbs: int = 12,
                           n_nouns: int = 9,
                           n_oscc: int = 24,
                           splits: tuple = ("train", "val", "test_unannotated"),
                           seed: int = 0,
                           learnable: bool = False) -> str:
    """Write a miniature Ego4D tree under ``root``; returns ``root``.

    The feature registry dimension is NOT enforced here — datasets read dims
    from the arrays; tests use small dims, the benchmark uses 1536.

    ``learnable=True`` plants class signal in the features: every feature row
    of an action window carries a (verb, noun)-dependent mean direction, and
    OSCC positive segments get a step change at the PNR frame. A correct
    pipeline then drives AR top-1 far above chance and OSCC above 50% within a
    few epochs — the end-to-end learning test the reference never had.
    """
    rng = np.random.default_rng(seed)
    stride = FEATURE_STRIDES[features]

    verb_dirs = rng.normal(size=(n_verbs, feature_dim)).astype(np.float32)
    noun_dirs = rng.normal(size=(n_nouns, feature_dim)).astype(np.float32)
    state_dir = rng.normal(size=(feature_dim,)).astype(np.float32)

    ann_dir = osp.join(root, "raw", "annotations", "v1")
    feat_dir = osp.join(root, "processed", "features", features)
    os.makedirs(ann_dir, exist_ok=True)
    os.makedirs(feat_dir, exist_ok=True)

    taxonomy = {
        "verbs": [f"verb_{i}" for i in range(n_verbs)],
        "nouns": [f"noun_{i}" for i in range(n_nouns)],
    }
    with open(osp.join(ann_dir, "fho_lta_taxonomy.json"), "w") as f:
        json.dump(taxonomy, f)

    video_uids = [f"vid_{i:04d}" for i in range(n_videos)]
    # ~45 frames per action → feature rows per video
    frames_per_action = 45
    video_frames = actions_per_clip * frames_per_action + 200

    # one label per (video, action) — shared by all splits so planted feature
    # signal stays consistent
    action_labels = {
        (uid, a): (int(rng.integers(0, n_verbs)), int(rng.integers(0, n_nouns)))
        for uid in video_uids for a in range(actions_per_clip)
    }
    state_coefs = {}
    for uid in video_uids:
        rows = video_frames // stride + 2
        feats = rng.normal(size=(rows, feature_dim)).astype(np.float32)
        if learnable:
            scale = 2.0 / np.sqrt(feature_dim)
            for a in range(actions_per_clip):
                v, n = action_labels[(uid, a)]
                lo = (a * frames_per_action) // stride
                hi = min(rows, (a * frames_per_action + frames_per_action - 5)
                         // stride + 1)
                feats[lo:hi] += scale * (verb_dirs[v] + noun_dirs[n])
            # smooth per-row state coefficient for OSCC/PNR signal
            coef = np.cumsum(rng.normal(size=rows)).astype(np.float32)
            coef = (coef - coef.mean()) / (coef.std() + 1e-6)
            feats += (coef[:, None] * state_dir[None]) * scale
            state_coefs[uid] = coef
        np.save(osp.join(feat_dir, f"{uid}.npy"), feats)

    for split in splits:
        fho_clips = []
        unannotated = "test" in split
        for v, uid in enumerate(video_uids):
            clip_uid = f"clip_{split}_{v:04d}"
            for a in range(actions_per_clip):
                start = a * frames_per_action
                end = start + frames_per_action - 5
                entry = {
                    "action_idx": a,
                    "video_uid": uid,
                    "clip_uid": clip_uid,
                    "clip_parent_start_frame": 0,
                    "action_clip_start_frame": start,
                    "action_clip_end_frame": end,
                }
                if not unannotated:  # test splits carry no labels
                    v, n = action_labels[(uid, a)]
                    entry["verb_label"] = v
                    entry["noun_label"] = n
                fho_clips.append(entry)
        with open(osp.join(ann_dir, f"fho_lta_{split}.json"), "w") as f:
            json.dump({"clips": fho_clips}, f)

        oscc_clips = []
        for i in range(n_oscc):
            uid = video_uids[i % n_videos]
            start_sec = float(rng.uniform(0, (video_frames / FPS) - 9))
            end_sec = start_sec + 8.0
            start_frame = int(start_sec * FPS)
            end_frame = int(end_sec * FPS)
            if unannotated:
                # real test_unannotated entries carry the frame metadata but
                # no state_change/parent_pnr_frame labels
                state_change = None
                pnr_frame = None
            elif learnable:
                # label derivable from the planted state coefficient: positive
                # iff the coefficient rises across the window
                coef = state_coefs[uid]
                lo, hi = start_frame // stride, end_frame // stride
                mid = (lo + hi) // 2
                state_change = int(coef[mid:hi].mean() > coef[lo:mid].mean())
                if state_change:
                    # PNR at the strongest single-step rise inside the window
                    step = np.diff(coef[lo:hi])
                    pnr_frame = int((lo + 1 + step.argmax()) * stride)
                else:
                    pnr_frame = None
            else:
                state_change = int(i % 2 == 0)
                pnr_frame = (int(rng.integers(start_frame + 10, end_frame - 10))
                             if state_change else None)
            entry = {
                "video_uid": uid,
                "unique_id": f"oscc_{split}_{i:05d}",
                "parent_start_frame": start_frame,
                "parent_end_frame": end_frame,
                "parent_start_sec": start_sec,
                "parent_end_sec": end_sec,
            }
            if not unannotated:
                entry["state_change"] = state_change
                entry["parent_pnr_frame"] = pnr_frame
            oscc_clips.append(entry)
        with open(osp.join(ann_dir, f"fho_oscc-pnr_{split}.json"), "w") as f:
            json.dump({"clips": oscc_clips}, f)

    return root
