"""Confusion-matrix plots (the port's copy of ``egopack_tpu/utils/plots.py``;
reference ``utils/plots.py:7-27``).

The heatmap is plain matplotlib on the headless Agg backend. Where
matplotlib is missing, as on a machine set up for the card alone, the
heatmap is skipped with a warning; the tables need numpy only.
"""

from __future__ import annotations

import logging
import os.path as osp
from typing import List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _normalize(confusion: np.ndarray) -> np.ndarray:
    # the reference divides by (1 + row sum), so empty rows stay 0
    # (reference utils/plots.py:8-9)
    return confusion / (1 + confusion.sum(1, keepdims=True))


def plot_confusion_matrix(confusion, normalize: bool = True):
    """Heatmap figure of a (C, C) confusion matrix (reference
    utils/plots.py:7-13), or None when matplotlib is missing."""
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("matplotlib unavailable; skipping confusion heatmap")
        return None
    confusion = np.asarray(confusion, np.float64)
    if normalize:
        confusion = _normalize(confusion)
    fig, ax = plt.subplots(dpi=300)
    im = ax.imshow(confusion, cmap="viridis", aspect="auto",
                   interpolation="nearest")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("Actual")
    return fig


def save_confusion_heatmap(confusion, path: str,
                           normalize: bool = True) -> bool:
    """Render :func:`plot_confusion_matrix` to ``path`` (PNG); returns
    whether a file was written."""
    fig = plot_confusion_matrix(confusion, normalize=normalize)
    if fig is None:
        return False
    import matplotlib.pyplot as plt
    try:
        fig.savefig(path, bbox_inches="tight")
    finally:
        plt.close(fig)
    return True


def generate_confusion_table(confusion, labels: Sequence[str],
                             normalize: bool = True) -> List[Tuple[str, int]]:
    """``actual --> predicted`` rows with nonzero counts, the reference's
    wandb.Table payload (reference utils/plots.py:16-27). The reference
    normalizes and then casts to integers, so with ``normalize=True`` only
    cells that round down to 1 or more remain; so does this."""
    confusion = np.asarray(confusion, np.float64)
    if normalize:
        confusion = confusion / confusion.sum(1, keepdims=True)
    confusion = confusion.astype(np.int64)
    return [(f"{actual} --> {pred}", int(confusion[i][j]))
            for i, actual in enumerate(labels)
            for j, pred in enumerate(labels) if confusion[i][j] > 0]


def heatmap_path(run_dir: str, task: str, which: str, epoch: int) -> str:
    return osp.join(run_dir, f"confusion_{task}_{which}_ep{epoch}.png")
