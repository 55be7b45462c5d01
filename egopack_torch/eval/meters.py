"""Stateful meters with the reference protocol (update / print_logs /
get_logs); the port's copy of ``egopack_tpu/eval/meters.py``.

Mirrors reference utils/meters/: the meter factory dispatches on the
dataset type (``__init__.py:10-22``), each meter accumulates on the host and
computes at epoch end. Logits arrive as numpy (the validate loop fetched
them); the caller drops padded batch entries with the valid mask. The
t-SNE embedding of the features (``log_feature_plots``) needs
scikit-learn, imported at the call.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..data.fho import (Ego4dAnticipationDataset, Ego4dLTADataset,
                        Ego4dRecognitionDataset)
from ..data.osccpnr import Ego4dOSCCDataset, Ego4dPNRDataset
from . import metrics as M


def _mean_of(chunks: List[np.ndarray]) -> float:
    """Mean over the concatenated per-update arrays, 0.0 without any."""
    values = np.concatenate(chunks) if chunks else np.zeros(0)
    return float(np.mean(values)) if values.size else 0.0


class BaseMeter:
    """Loss + count tracking; optional feature accumulation for t-SNE plots
    (reference utils/meters/base.py:10-52)."""

    def __init__(self, save_features: bool = False):
        self.save_features = save_features
        self._loss_sum = 0.0
        self._loss_count = 0
        self._samples = 0
        self._pre_features: List[np.ndarray] = []
        self._post_features: List[np.ndarray] = []
        # epoch-end metrics are O(val set) to compute and the driver reads
        # them several times (print_logs + run_logger + return value);
        # compute once per update-generation
        self._logs_cache = None

    def update_features(self, pre=None, post=None):
        if not self.save_features:
            return
        if pre is not None:
            self._pre_features.append(np.asarray(pre).reshape(
                -1, np.asarray(pre).shape[-1]))
        if post is not None:
            self._post_features.append(np.asarray(post).reshape(
                -1, np.asarray(post).shape[-1]))

    def feature_embedding(self, which: str = "post", max_points: int = 2000):
        """2-D t-SNE coordinates of the first ``max_points`` accumulated
        features (the reference's wandb scatter plot, base.py:36-39), as
        (n, 2) numpy, or None without features. Needs scikit-learn; where
        it is missing the ImportError reaches the caller."""
        feats = self._post_features if which == "post" else self._pre_features
        if not feats:
            return None
        from sklearn.manifold import TSNE
        data = np.concatenate(feats)[:max_points]
        perplexity = min(30.0, max(1.0, (len(data) - 1) / 3))
        return TSNE(2, perplexity=perplexity).fit_transform(data)

    def update_loss(self, loss: float, n: int = 1):
        """Equal-weight batch mean: the reference feeds the per-batch scalar
        loss to a torchmetrics MeanMetric with weight 1 per update
        (reference utils/meters/base.py:14,23), NOT weighted by batch
        size; ``n`` only feeds the sample counter."""
        if np.isnan(loss):
            raise ValueError("NaN loss in meter (reference nan_strategy=error)")
        self._logs_cache = None
        self._loss_sum += float(loss)
        self._loss_count += 1
        self._samples += n

    @property
    def loss(self) -> float:
        return self._loss_sum / max(self._loss_count, 1)

    # ---- accumulator state, merged over ranks in sharded validation ----
    # the per-update list accumulators of a subclass: one entry per update
    _STATE_LISTS: tuple = ()
    # features ride the exchange only up to the t-SNE sample budget
    # (egopack_tpu/eval/meters.py:79-98), subsampled uniformly over the
    # epoch; this bounds the plots only, every metric merges exactly
    FEATURE_WIRE_CAP = 2000

    def _capped(self, feats: List[np.ndarray]) -> List[np.ndarray]:
        total = sum(len(f) for f in feats)
        if total <= self.FEATURE_WIRE_CAP:
            return list(feats)
        cat = np.concatenate([np.asarray(f) for f in feats], axis=0)
        idx = np.round(np.linspace(0, total - 1,
                                   self.FEATURE_WIRE_CAP)).astype(np.int64)
        return [cat[idx]]

    def state(self) -> Dict:
        """A snapshot of the accumulators: scalars and lists of numeric
        arrays (``egopack_tpu/eval/meters.py:100-111``)."""
        st = {"loss_sum": self._loss_sum, "loss_count": self._loss_count,
              "samples": self._samples,
              "pre": self._capped(self._pre_features),
              "post": self._capped(self._post_features)}
        for name in self._STATE_LISTS:
            st[name] = list(getattr(self, name))
        return st

    def merge_state(self, st: Dict, include_loss: bool = True) -> None:
        """Fold another meter's ``state()`` in after this one's updates
        (``egopack_tpu/eval/meters.py:113-130``). ``include_loss=False``
        keeps the loss accumulators: with a global per-batch loss every
        rank has recorded the same series."""
        self._logs_cache = None
        if include_loss:
            self._loss_sum += st["loss_sum"]
            self._loss_count += st["loss_count"]
        self._samples += st["samples"]
        self._pre_features.extend(st["pre"])
        self._post_features.extend(st["post"])
        for name in self._STATE_LISTS:
            getattr(self, name).extend(st[name])

    def merge_states(self, states: List[Dict]) -> None:
        """Replace the list accumulators by those of ``states``, the data
        axis's meters in rank order, interleaved update by update: each
        update is one global batch's block, so the merged lists hold the
        rows in the order one process over the global batches appends them
        and every metric is that process's, exactly. The loss accumulators
        stay (see ``merge_state``)."""
        for name in self._STATE_LISTS:
            n = {len(st[name]) for st in states}
            if len(n) > 1:
                raise ValueError(f"ranks metered different numbers of "
                                 f"batches: {name} {sorted(n)}")
        self._logs_cache = None
        self._samples = sum(st["samples"] for st in states)
        self._pre_features = [f for st in states for f in st["pre"]]
        self._post_features = [f for st in states for f in st["post"]]
        for name in self._STATE_LISTS:
            setattr(self, name, [st[name][i]
                                 for i in range(len(states[0][name]))
                                 for st in states])

    def print_logs(self) -> List[str]:
        return [f"Loss: {self.loss:.4f}"]

    def get_logs(self) -> Dict[str, float]:
        if self._logs_cache is None:
            self._logs_cache = self._logs()
        return dict(self._logs_cache)

    def _logs(self) -> Dict[str, float]:
        return {"loss": self.loss}


class Ego4dRecognitionMeter(BaseMeter):
    """Verb/noun top-{1,2,3,5}, macro, calibration, Brier, confusions,
    per-class accuracy tables (reference utils/meters/ego4d.py:34-203)."""

    _STATE_LISTS = ("_verb_logits", "_verb_labels",
                    "_noun_logits", "_noun_labels")

    def __init__(self, dataset, log_confusion: bool = False, **kw):
        super().__init__(**kw)
        self.n_verbs, self.n_nouns = dataset.num_class_labels
        self.class_labels = dataset.class_labels
        self.log_confusion = log_confusion
        self._verb_logits, self._verb_labels = [], []
        self._noun_logits, self._noun_labels = [], []

    def update(self, logits, labels, loss: float):
        verb_logits, noun_logits = logits
        self._verb_logits.append(np.asarray(verb_logits, np.float32))
        self._noun_logits.append(np.asarray(noun_logits, np.float32))
        labels = np.asarray(labels)
        self._verb_labels.append(labels[:, 0])
        self._noun_labels.append(labels[:, 1])
        self.update_loss(loss, len(labels))


    def _compute(self, which: str) -> Dict[str, float]:
        if which == "verbs":
            logits = np.concatenate(self._verb_logits)
            labels = np.concatenate(self._verb_labels)
            n = self.n_verbs
        else:
            logits = np.concatenate(self._noun_logits)
            labels = np.concatenate(self._noun_labels)
            n = self.n_nouns
        out = {f"{which}_top{k}": M.topk_accuracy_micro(logits, labels, k)
               for k in (1, 2, 3, 5)}
        out[f"{which}_mc"] = M.macro_accuracy(logits, labels, n)
        out[f"{which}_calibration_error"] = M.calibration_error(logits, labels)
        out[f"{which}_brier_score"] = M.calibration_error(logits, labels,
                                                          n_bins=1, norm="l2")
        return out

    def confusion(self, which: str = "verbs") -> np.ndarray:
        """Full (C, C) confusion matrix — feeds the heatmap frontend
        (reference utils/plots.py:7-13 via ego4d.py:134-146)."""
        if which == "verbs":
            logits = np.concatenate(self._verb_logits)
            labels = np.concatenate(self._verb_labels)
            n = self.n_verbs
        else:
            logits = np.concatenate(self._noun_logits)
            labels = np.concatenate(self._noun_labels)
            n = self.n_nouns
        return M.confusion_matrix(logits, labels, n)

    def confusion_tables(self, which: str = "verbs", top_n: int = 25):
        """Top-2 confusion table + per-class accuracy/support table (the
        reference's wandb.Tables, ego4d.py:134-203), as plain dicts."""
        if which == "verbs":
            logits = np.concatenate(self._verb_logits)
            labels = np.concatenate(self._verb_labels)
            names, n = self.class_labels[0], self.n_verbs
        else:
            logits = np.concatenate(self._noun_logits)
            labels = np.concatenate(self._noun_labels)
            names, n = self.class_labels[1], self.n_nouns
        cm2 = M.top2_confusion(logits, labels, n)
        flat = cm2.flatten()
        order = np.argsort(-flat)[:top_n]
        top2_rows = [[names[i // n], names[i % n], int(flat[i])]
                     for i in order if flat[i] > 0]
        support = M.confusion_matrix(logits, labels, n).sum(1)
        per_class = {
            "class": list(names),
            "top-1": M.per_class_topk_accuracy(logits, labels, 1, n)[0].tolist(),
            "top-2": M.per_class_topk_accuracy(logits, labels, 2, n)[0].tolist(),
            "top-5": M.per_class_topk_accuracy(logits, labels, 5, n)[0].tolist(),
            "support": support.tolist(),
        }
        return {"top2_confusion": top2_rows, "class_acc": per_class}

    def print_logs(self) -> List[str]:
        logs = self.get_logs()
        return [
            "Verbs Top-1: {:.2f}, Top-2: {:.2f}, Top-3: {:.2f}, Top-5: {:.2f}".format(
                *(logs[f"verbs_top{k}"] * 100 for k in (1, 2, 3, 5))),
            "Nouns Top-1: {:.2f}, Top-2: {:.2f}, Top-3: {:.2f}, Top-5: {:.2f}".format(
                *(logs[f"nouns_top{k}"] * 100 for k in (1, 2, 3, 5))),
            f"Verbs Mean class: {logs['verbs_mc'] * 100:.2f}",
            f"Nouns Mean class: {logs['nouns_mc'] * 100:.2f}",
            f"Verbs Brier score: {logs['verbs_brier_score']:.4f}",
            f"Nouns Brier score: {logs['nouns_brier_score']:.4f}",
            *super().print_logs(),
        ]

    def _logs(self) -> Dict[str, float]:
        return {**self._compute("verbs"), **self._compute("nouns"),
                **super()._logs()}


class Ego4dOSCCMeter(BaseMeter):
    """2-class micro accuracy (reference utils/meters/ego4d.py:300-329)."""

    _STATE_LISTS = ("_logits", "_labels")

    def __init__(self, dataset=None, **kw):
        super().__init__(**kw)
        self._logits, self._labels = [], []

    def update(self, logits, labels, loss: float):
        self._logits.append(np.asarray(logits, np.float32))
        self._labels.append(np.asarray(labels))
        self.update_loss(loss, len(np.asarray(labels)))


    @property
    def accuracy(self) -> float:
        return M.topk_accuracy_micro(np.concatenate(self._logits),
                                     np.concatenate(self._labels), 1)

    def print_logs(self) -> List[str]:
        return [f"Accuracy: {self.get_logs()['accuracy'] * 100:.2f}",
                *super().print_logs()]

    def _logs(self) -> Dict[str, float]:
        return {"accuracy": self.accuracy, **super()._logs()}


class Ego4dPNRMeter(BaseMeter):
    """Binary acc/recall/AUROC + keyframe localization error in seconds
    (reference utils/meters/ego4d.py:332-389): predicted keyframe index
    is mapped via ``(end−start)/16 · argmax`` then compared to the PNR offset."""

    _STATE_LISTS = ("_probs", "_labels", "loc_errors")

    def __init__(self, dataset=None, num_segments: int = 16, **kw):
        super().__init__(**kw)
        self.num_segments = num_segments
        self._probs, self._labels = [], []
        # one array of errors per update
        self.loc_errors: List[np.ndarray] = []

    def update(self, logits, labels, loss: float, start_frame=None,
               end_frame=None, pnr_frame=None):
        probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))  # (B, N)
        labels = np.asarray(labels)
        self._probs.append(probs.reshape(-1))
        self._labels.append(labels.reshape(-1))
        self.update_loss(loss, labels.shape[0])
        if start_frame is not None:
            # the frames' dtype throughout, as per-sample scalars give it
            sf, ef, pf = (np.asarray(a) for a in (start_frame, end_frame,
                                                  pnr_frame))
            step = (ef - sf) / 16
            pred_mapped = step * probs.argmax(-1).astype(step.dtype)
            self.loc_errors.append(np.abs(pred_mapped - (pf - sf)) / 30.0)


    def _logs(self) -> Dict[str, float]:
        probs = np.concatenate(self._probs)
        labels = np.concatenate(self._labels)
        return {
            "accuracy": M.binary_accuracy(probs, labels),
            "recall": M.binary_recall(probs, labels),
            "auroc": M.binary_auroc(probs, labels),
            "localization_error": float(np.mean(np.concatenate(
                self.loc_errors))) if self.loc_errors else 0.0,
            **super()._logs(),
        }

    def print_logs(self) -> List[str]:
        logs = self.get_logs()
        return [f"accuracy: {logs['accuracy']:.4f}",
                f"recall: {logs['recall']:.4f}",
                f"auroc: {logs['auroc']:.4f}",
                f"localization_error: {logs['localization_error']:.4f}",
                *super().print_logs()]


class Ego4dLTAMeter(BaseMeter):
    """Best-of-K edit distance over the 20 forecast steps + node top-1
    (reference utils/meters/ego4d.py:392-453)."""

    _STATE_LISTS = ("_ed_verbs", "_ed_nouns", "_v_logits", "_v_labels",
                    "_n_logits", "_n_labels")

    def __init__(self, dataset, num_nodes: int = 22, num_input: int = 2, **kw):
        super().__init__(**kw)
        self.n_verbs, self.n_nouns = dataset.num_class_labels
        self.num_nodes = num_nodes
        self.num_input = num_input
        self._ed_verbs, self._ed_nouns = [], []
        self._v_logits, self._v_labels = [], []
        self._n_logits, self._n_labels = [], []

    def update(self, logits, labels, predictions, loss: float):
        """logits: (verb (B·N, V), noun (B·N, C)); predictions: same shapes
        with a trailing K axis; labels: (B·N, 2)."""
        labels = np.asarray(labels)
        vl, nl = np.asarray(logits[0], np.float32), np.asarray(logits[1], np.float32)
        vm, nm = labels[:, 0] >= 0, labels[:, 1] >= 0
        self._v_logits.append(vl[vm]); self._v_labels.append(labels[vm, 0])
        self._n_logits.append(nl[nm]); self._n_labels.append(labels[nm, 1])
        pv = np.asarray(predictions[0]).reshape(-1, self.num_nodes, 5)
        pn = np.asarray(predictions[1]).reshape(-1, self.num_nodes, 5)
        lv = labels[:, 0].reshape(-1, self.num_nodes)
        ln = labels[:, 1].reshape(-1, self.num_nodes)
        ni = self.num_input
        # one array of distances per update
        self._ed_verbs.append(M.sequence_edit_distance(pv[:, ni:], lv[:, ni:]))
        self._ed_nouns.append(M.sequence_edit_distance(pn[:, ni:], ln[:, ni:]))
        self.update_loss(loss, labels.shape[0])

    def _logs(self) -> Dict[str, float]:
        return {
            "verbs_ed": _mean_of(self._ed_verbs),
            "nouns_ed": _mean_of(self._ed_nouns),
            "verbs_top1": M.topk_accuracy_micro(np.concatenate(self._v_logits),
                                                np.concatenate(self._v_labels), 1),
            "nouns_top1": M.topk_accuracy_micro(np.concatenate(self._n_logits),
                                                np.concatenate(self._n_labels), 1),
            **super()._logs(),
        }

    def print_logs(self) -> List[str]:
        logs = self.get_logs()
        return [f"verbs_ed: {logs['verbs_ed']:.4f}",
                f"nouns_ed: {logs['nouns_ed']:.4f}",
                f"verbs_top1: {logs['verbs_top1']:.4f}",
                f"nouns_top1: {logs['nouns_top1']:.4f}",
                *super().print_logs()]


class Ego4dAnticipationMeter(BaseMeter):
    """Verb/noun top-k accuracy + mean-class recall
    (reference utils/meters/ego4d.py:206-297)."""

    _STATE_LISTS = ("_v_logits", "_v_labels", "_n_logits", "_n_labels")

    def __init__(self, dataset, **kw):
        super().__init__(**kw)
        self._v_logits, self._v_labels = [], []
        self._n_logits, self._n_labels = [], []

    def update(self, logits, labels, loss: float):
        labels = np.asarray(labels)
        vl, nl = np.asarray(logits[0], np.float32), np.asarray(logits[1], np.float32)
        vm, nm = labels[:, 0] != -1, labels[:, 1] != -1
        self._v_logits.append(vl[vm]); self._v_labels.append(labels[vm, 0])
        self._n_logits.append(nl[nm]); self._n_labels.append(labels[nm, 1])
        self.update_loss(loss, labels.shape[0])

    def _logs(self) -> Dict[str, float]:
        vl, vt = np.concatenate(self._v_logits), np.concatenate(self._v_labels)
        nl, nt = np.concatenate(self._n_logits), np.concatenate(self._n_labels)
        out = {}
        for k in (1, 2, 3, 5):
            out[f"verbs_accuracy_top{k}"] = M.topk_accuracy_micro(vl, vt, k)
            out[f"nouns_accuracy_top{k}"] = M.topk_accuracy_micro(nl, nt, k)
            out[f"verbs_recall_top{k}"] = M.topk_recall(vl, vt, k)
            out[f"nouns_recall_top{k}"] = M.topk_recall(nl, nt, k)
        out.update(super()._logs())
        return out


def build_meter_for_dataset(dataset, save_features: bool = False,
                            log_confusion: bool = False) -> BaseMeter:
    """isinstance dispatch (reference utils/meters/__init__.py:10-22);
    order matters: PNR before OSCC (subclass), LTA/Anticipation before FHO.

    ``save_features`` reaches EVERY meter (the reference's BaseMeter collects
    pre/post features regardless of subclass, utils/meters/base.py:18-29);
    ``log_confusion`` applies to the Recognition meter only — confusion
    matrices exist only there in the reference too (ego4d.py:51-68)."""
    if isinstance(dataset, Ego4dRecognitionDataset):
        return Ego4dRecognitionMeter(dataset, save_features=save_features,
                                     log_confusion=log_confusion)
    if isinstance(dataset, Ego4dAnticipationDataset):
        return Ego4dAnticipationMeter(dataset, save_features=save_features)
    if isinstance(dataset, Ego4dPNRDataset):
        return Ego4dPNRMeter(dataset, num_segments=dataset.num_segments,
                             save_features=save_features)
    if isinstance(dataset, Ego4dOSCCDataset):
        return Ego4dOSCCMeter(dataset, save_features=save_features)
    if isinstance(dataset, Ego4dLTADataset):
        return Ego4dLTAMeter(
            dataset,
            num_nodes=dataset.n_input_clips + dataset.n_forecast_clips,
            num_input=dataset.n_input_clips, save_features=save_features)
    raise NotImplementedError(type(dataset))
