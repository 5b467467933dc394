"""Lesion-wise (instance) detection metrics, the MSSEG2 challenge criterion,
ported from segmentation_pipeline_tpu/evaluators/instance_segmentation_evaluator.py:
the msseg detection test (min_recall alpha, contribution threshold gamma,
min_precision 1-beta) over a target-vs-prediction connected-component overlap
histogram. Components are labelled by the port's native labeller
(native.py) with skimage's connectivity convention (2: the 18-neighbourhood
in 3-D); the overlap histogram is an exact 2-D bincount. ``subject_stats``
is a ``Table``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np

from .evaluator import Evaluator
from .labeled_tensor import LabeledTensor

#: subject attribute carrying overlap histograms computed on the device
#: ({(pred_name, target_name, connectivity): {"hist", "n_target",
#: "n_pred"}}), written by training/device_confusion.py once its probe
#: sweep has held the device reduction (ops/instance.py) to this module's
#: host chain, exactly
DEVICE_INSTANCE_KEY = "_device_instance"


def connected_components(mask: np.ndarray, connectivity: int = 2):
    """Label a 3-D boolean mask; connectivity in {1, 2, 3} = 6/18/26
    neighbourhood (skimage convention), on the native labeller."""
    from ..native import connected_components_native

    return connected_components_native(mask, connectivity)


def overlap_histogram(target_components: np.ndarray, pred_components: np.ndarray,
                      n_target: int, n_pred: int) -> np.ndarray:
    """(N+1, M+1) histogram: [i, j] = overlapping voxel count between target
    component i and predicted component j (0 = background)."""
    combined = target_components.astype(np.int64) * (n_pred + 1) + pred_components
    counts = np.bincount(combined.ravel(), minlength=(n_target + 1) * (n_pred + 1))
    return counts.reshape(n_target + 1, n_pred + 1).astype(np.float64)


def msseg_detection_test(hist: np.ndarray, min_recall: float = 0.1,
                         contribution_threshold: float = 0.65,
                         min_precision: float = 0.3) -> np.ndarray:
    """Per-target-instance detection decision from the MSSEG infrastructure
    paper (alpha=min_recall, gamma=contribution_threshold,
    1-beta=min_precision). Returns a boolean array of length N."""
    N = hist.shape[0] - 1
    target_volume = hist.sum(axis=1)
    prediction_volume = hist.sum(axis=0)

    detected = []
    for i in range(1, N + 1):
        target_tp = hist[i, 1:].sum()
        recall = target_tp / target_volume[i] if target_volume[i] else 0.0
        if recall < min_recall:
            detected.append(False)
            continue

        order = np.argsort(-hist[i, 1:], kind="stable") + 1
        contribution_total = 0.0
        for j in order:
            precision = hist[i, j] / prediction_volume[j] if prediction_volume[j] else 0.0
            if precision < min_precision:
                detected.append(False)
                break
            contribution_total += hist[i, j] / target_tp
            if contribution_total >= contribution_threshold:
                detected.append(True)
                break
    return np.array(detected, dtype=bool)


class InstanceSegmentationEvaluator(Evaluator):
    def __init__(self, prediction_label_map_name: str, target_label_map_name: str,
                 stats_to_output: Sequence[str] = (
                     "target_components", "predicted_components",
                     "target_detections", "predicted_detections",
                     "detection_recall", "detection_precision", "detection_f1",
                     "target_volume", "prediction_volume", "TP", "FP", "TN", "FN",
                     "dice", "jaccard", "precision", "recall"),
                 summary_stats_to_output: Sequence[str] = ("mean", "std", "min", "max",
                                                           "median", "mode"),
                 connectivity: int = 2,
                 detection_test: Callable = None,
                 detection_test_params: Dict[str, Any] = None):
        self.prediction_label_map_name = prediction_label_map_name
        self.target_label_map_name = target_label_map_name
        self.stats_to_output = stats_to_output
        self.summary_stats_to_output = summary_stats_to_output
        self.connectivity = connectivity
        self.detection_test = detection_test or msseg_detection_test
        self.detection_test_params = detection_test_params or {}

    def _device_entry(self, subject):
        entries = subject.get(DEVICE_INSTANCE_KEY)
        if isinstance(entries, dict):
            return entries.get((self.prediction_label_map_name,
                                self.target_label_map_name,
                                self.connectivity))
        return None

    def __call__(self, subjects):
        subject_names = [s["name"] for s in subjects]
        subject_stats = LabeledTensor(dim_names=["subject", "stat"],
                                      dim_keys=[subject_names, list(self.stats_to_output)])

        for subject in subjects:
            entry = self._device_entry(subject)
            if entry is not None:
                # computed on the device (held to this host chain by the
                # probe sweep; training/device_confusion.py)
                N, M = entry["n_target"], entry["n_pred"]
                hist = entry["hist"]
            else:
                pred_mask = np.asarray(
                    subject[self.prediction_label_map_name].data)[0] > 0
                target_mask = np.asarray(
                    subject[self.target_label_map_name].data)[0] > 0

                pred_comp, M = connected_components(pred_mask, self.connectivity)
                target_comp, N = connected_components(target_mask, self.connectivity)

                hist = overlap_histogram(target_comp, pred_comp, N, M)

            target_detected = self.detection_test(hist, **self.detection_test_params)
            prediction_detected = self.detection_test(hist.T, **self.detection_test_params)

            with np.errstate(divide="ignore", invalid="ignore"):
                detection_recall = np.float64(target_detected.sum()) / N
                detection_precision = np.float64(prediction_detected.sum()) / M
                detection_f1 = (2 * detection_recall * detection_precision
                                / (detection_recall + detection_precision))

                tp = hist[1:, 1:].sum()
                fp = hist[0, 1:].sum()
                tn = hist[0, 0]
                fn = hist[1:, 0].sum()

                stats = {
                    "target_components": N,
                    "predicted_components": M,
                    "target_detections": target_detected.sum(),
                    "predicted_detections": prediction_detected.sum(),
                    "detection_recall": detection_recall,
                    "detection_precision": detection_precision,
                    "detection_f1": detection_f1,
                    "target_volume": tp + fn,
                    "prediction_volume": tp + fp,
                    "TP": tp,
                    "FP": fp,
                    "TN": tn,
                    "FN": fn,
                    "dice": 2 * tp / (2 * tp + fp + fn),
                    "jaccard": tp / (tp + fp + fn),
                    "precision": tp / (tp + fp),
                    "recall": tp / (tp + fn),
                }

            for stat_name in self.stats_to_output:
                subject_stats[subject["name"], stat_name] = float(stats[stat_name])

        summary_stats = subject_stats.compute_summary_stats(self.summary_stats_to_output)
        return {
            "subject_stats": subject_stats.to_table(),
            "summary_stats": summary_stats,
        }
