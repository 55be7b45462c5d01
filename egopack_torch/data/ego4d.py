"""Ego4D pre-extracted feature registry (the port's copy of
``egopack_tpu/data/ego4d.py``).

Mirrors reference data/ego4d.py:1-21 (window/stride/dim constants per
feature backbone, from https://ego4d-data.org/docs/data/features/). The
reference's default config names ``slowfast8x8_r101_k400`` which is absent from
its own registry (documented defect, SURVEY.md §2.1); here every backbone named
by a config must be registered, and we default configs to omnivore as all
reference experiments do.
"""

from typing import Dict

# Canonical videos are all 30 FPS (reference data/ego4d_oscc.py:40)
FPS = 30

FEATURE_WINDOW_SIZES: Dict[str, int] = {
    "omnivore_image_swinl": 1,
    "omnivore_video_swinl": 32,
    "slowfast8x8_r101_k400": 32,
}

FEATURE_STRIDES: Dict[str, int] = {
    "omnivore_image_swinl": 5,
    "omnivore_video_swinl": 16,
    "slowfast8x8_r101_k400": 16,
}

FEATURE_SIZES: Dict[str, int] = {
    "omnivore_image_swinl": 1536,
    "omnivore_video_swinl": 1536,
    "slowfast8x8_r101_k400": 2304,
}
