"""Voxel-overlap segmentation metrics, ported from
segmentation_pipeline_tpu/evaluators/segmentation_evaluator.py: per
(subject, named label) TP/FP/TN/FN and dice/jaccard/precision/recall, plus
summary stats.

For integer label maps the JAX package builds the (L+1) x (L+1) joint
confusion histogram in its native C library; the port builds the same
integer counts with one ``np.bincount`` over ``target_bucket * (L + 1) +
pred_bucket``, so the stats are equal exactly. ``subject_stats`` is a
``Table``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .evaluator import Evaluator
from .labeled_tensor import LabeledTensor

#: subject attribute carrying joint histograms computed on the device
#: ({(pred_name, target_name): {"joint": (L+1, L+1), "label_values": {...}}}),
#: written by training/device_confusion.py once its probe sweep has held
#: the device reduction to this module's host counts, exactly
DEVICE_CONFUSION_KEY = "_device_confusion"

STATS = ("target_volume", "prediction_volume", "TP", "FP", "TN", "FN",
         "dice", "jaccard", "precision", "recall")


def joint_histogram(target: np.ndarray, pred: np.ndarray, lut: np.ndarray, L: int) -> np.ndarray:
    """(L+1) x (L+1) int64 counts of (target bucket, prediction bucket):
    ``lut`` maps a value to its bucket in [0, L]; values outside
    [0, len(lut)) go to bucket L ("not a named label"). Values are taken as
    int32, as the JAX package's native pass reads them."""
    def buckets(a):
        a = np.asarray(a).reshape(-1).astype(np.int32, copy=False)
        inside = (a >= 0) & (a < len(lut))
        return np.where(inside, lut[np.where(inside, a, 0)], L).astype(np.int64)

    stride = L + 1
    counts = np.bincount(buckets(target) * stride + buckets(pred), minlength=stride * stride)
    return counts.reshape(stride, stride)


def confusion_stats(pred: np.ndarray, target: np.ndarray, label_values: dict) -> dict:
    """pred/target: (C, W, H, D) label maps. Returns {stat: {label_name:
    value}} with float math (0/0 -> nan, x/0 -> inf). Integer maps go
    through the joint histogram; others through per-label boolean
    reductions."""
    names = list(label_values.keys())
    values = [int(label_values[n]) for n in names]
    L = len(names)
    pred = np.asarray(pred)
    target = np.asarray(target)
    n_vox = float(pred.size)

    vmax = max(max(values), 0)
    if np.issubdtype(pred.dtype, np.integer) and \
            np.issubdtype(target.dtype, np.integer) and vmax < 1 << 20:
        lut = np.full(vmax + 1, L, dtype=np.int32)
        for i, v in enumerate(values):
            if v >= 0:
                lut[v] = i
        return stats_from_joint(joint_histogram(target, pred, lut, L), names)

    out = {stat: {} for stat in STATS}
    per_label = []
    for v in values:
        p = pred == v
        t = target == v
        tp = float(np.logical_and(t, p).sum())
        fp = float(np.logical_and(~t, p).sum())
        fn = float(np.logical_and(t, ~p).sum())
        per_label.append((tp, fn, fp))
    _fill_stats(out, names, per_label, n_vox)
    return out


def stats_from_joint(joint: np.ndarray, names: Sequence[str]) -> dict:
    """Derive every per-label stat from an (L+1) x (L+1) joint confusion
    histogram (row = target bucket, col = prediction bucket, bucket L =
    other)."""
    L = len(names)
    n_vox = float(joint.sum())
    diag = np.diag(joint)[:L].astype(np.float64)
    row = joint.sum(axis=1)[:L].astype(np.float64)  # target counts
    col = joint.sum(axis=0)[:L].astype(np.float64)  # prediction counts
    per_label = [(diag[i], row[i] - diag[i], col[i] - diag[i])
                 for i in range(L)]
    out = {stat: {} for stat in STATS}
    _fill_stats(out, names, per_label, n_vox)
    return out


def _fill_stats(out, names, per_label, n_vox):
    for name, (tp, fn, fp) in zip(names, per_label):
        tn = n_vox - tp - fp - fn
        out["target_volume"][name] = tp + fn
        out["prediction_volume"][name] = tp + fp
        out["TP"][name] = tp
        out["FP"][name] = fp
        out["TN"][name] = tn
        out["FN"][name] = fn
        out["dice"][name] = _div(2 * tp, 2 * tp + fp + fn)
        out["jaccard"][name] = _div(tp, tp + fp + fn)
        out["precision"][name] = _div(tp, tp + fp)
        out["recall"][name] = _div(tp, tp + fn)


def _div(a: float, b: float) -> float:
    if b == 0:
        return float("nan") if a == 0 else float("inf")
    return a / b


class SegmentationEvaluator(Evaluator):
    """Evaluates prediction vs target label maps named in each subject; both
    must share an identical 'label_values' dict."""

    def __init__(self, prediction_label_map_name: str, target_label_map_name: str,
                 stats_to_output: Sequence[str] = ("target_volume", "prediction_volume",
                                                   "TP", "FP", "TN", "FN",
                                                   "dice", "precision", "recall"),
                 summary_stats_to_output: Sequence[str] = ("mean", "std", "min", "max")):
        self.prediction_label_map_name = prediction_label_map_name
        self.target_label_map_name = target_label_map_name
        self.stats_to_output = stats_to_output
        self.summary_stats_to_output = summary_stats_to_output

    def _device_entry(self, subject):
        entries = subject.get(DEVICE_CONFUSION_KEY)
        if isinstance(entries, dict):
            return entries.get((self.prediction_label_map_name, self.target_label_map_name))
        return None

    def __call__(self, subjects):
        if not subjects:
            # an empty cohort still produces a result: the trainer always
            # emits the cohort key, and scoring functions index it
            empty = LabeledTensor(
                dim_names=["subject", "label", "stat"],
                dim_keys=[[], [], list(self.stats_to_output)])
            return {
                "subject_stats": empty.to_table(),
                "summary_stats": empty.compute_summary_stats(
                    self.summary_stats_to_output),
            }
        entry0 = self._device_entry(subjects[0])
        if entry0 is not None:
            # a sweep reduced on the device attaches no eval images
            label_values = entry0["label_values"]
        else:
            label_values = subjects[0][self.prediction_label_map_name]["label_values"]
        label_names = list(label_values.keys())
        subject_names = [s["name"] for s in subjects]

        subject_stats = LabeledTensor(
            dim_names=["subject", "label", "stat"],
            dim_keys=[subject_names, label_names, list(self.stats_to_output)])

        for subject in subjects:
            entry = self._device_entry(subject)
            if entry is not None:
                # counted on the device (training/device_confusion.py)
                stats = stats_from_joint(entry["joint"], label_names)
            else:
                pred = np.asarray(subject[self.prediction_label_map_name].data)
                target = np.asarray(subject[self.target_label_map_name].data)
                stats = confusion_stats(pred, target, label_values)
            for label_name in label_names:
                for stat_name in self.stats_to_output:
                    subject_stats[subject["name"], label_name, stat_name] = \
                        stats[stat_name][label_name]

        summary_stats = subject_stats.compute_summary_stats(self.summary_stats_to_output)
        return {
            "subject_stats": subject_stats.to_table(),
            "summary_stats": summary_stats,
        }
