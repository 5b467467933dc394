"""Label-map volume statistics with optional age-curve plausibility check,
copied from segmentation_pipeline_tpu/evaluators/label_map_evaluator.py:
per-label volumes plus error/absolute_error/squared_error/percent_diff
against a polynomial volume-vs-attribute curve (dmri_hippo's check of the
unlabeled ab300 cohort). ``subject_stats`` is a ``Table``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np

from .evaluator import Evaluator
from .labeled_tensor import LabeledTensor

CURVE_STATS = ("error", "absolute_error", "squared_error", "percent_diff")


class LabelMapEvaluator(Evaluator):
    def __init__(self, label_map_name: str,
                 curve_params: Union[Dict[str, np.ndarray], None] = None,
                 curve_attribute: Union[str, None] = None,
                 stats_to_output: Sequence[str] = ("volume",),
                 summary_stats_to_output: Sequence[str] = ("mean", "std", "min", "max")):
        self.label_map_name = label_map_name
        self.curve_params = curve_params
        self.curve_attribute = curve_attribute
        self.stats_to_output = stats_to_output
        self.summary_stats_to_output = summary_stats_to_output

        if any(stat in CURVE_STATS for stat in self.stats_to_output):
            if curve_params is None:
                raise ValueError("curve_params must be provided")
            if curve_attribute is None:
                raise ValueError("curve_attribute must be provided")

        if curve_params is not None and curve_attribute is not None:
            self.poly_func = {label: np.poly1d(np.asarray(param))
                              for label, param in curve_params.items()}
        else:
            self.poly_func = None

    def __call__(self, subjects):
        if not subjects:
            empty = LabeledTensor(
                dim_names=["subject", "label", "stat"],
                dim_keys=[[], [], list(self.stats_to_output)])
            return {
                "subject_stats": empty.to_table(),
                "summary_stats": empty.compute_summary_stats(
                    self.summary_stats_to_output),
            }
        label_values = subjects[0][self.label_map_name]["label_values"]
        label_names = list(label_values.keys())
        subject_names = [s["name"] for s in subjects]

        subject_stats = LabeledTensor(
            dim_names=["subject", "label", "stat"],
            dim_keys=[subject_names, label_names, list(self.stats_to_output)])

        for subject in subjects:
            data = np.asarray(subject[self.label_map_name].data)
            for label_name, label_value in label_values.items():
                volume = float((data == label_value).sum())
                stats = {"volume": volume}
                if self.poly_func is not None:
                    predicted = float(self.poly_func[label_name](subject[self.curve_attribute]))
                    error = volume - predicted
                    stats.update({
                        "error": error,
                        "absolute_error": abs(error),
                        "squared_error": error ** 2,
                        "percent_diff": (error / predicted) * 100 if predicted else float("nan"),
                    })
                for stat_name in self.stats_to_output:
                    subject_stats[subject["name"], label_name, stat_name] = stats[stat_name]

        summary_stats = subject_stats.compute_summary_stats(self.summary_stats_to_output)
        return {
            "subject_stats": subject_stats.to_table(),
            "summary_stats": summary_stats,
        }
