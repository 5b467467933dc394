"""Intensity-in-mask evaluator, ported from
segmentation_pipeline_tpu/evaluators/image_region_evaluator.py: statistics
of a scalar image's intensities inside each named label region.
``subject_stats`` is a ``Table``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .evaluator import Evaluator
from .labeled_tensor import LabeledTensor


class ImageRegionEvaluator(Evaluator):
    def __init__(self, image_name: str, label_map_name: str,
                 stats_to_output: Sequence[str] = ("mean", "std", "min", "max"),
                 summary_stats_to_output: Sequence[str] = ("mean", "std", "min", "max")):
        self.image_name = image_name
        self.label_map_name = label_map_name
        self.stats_to_output = stats_to_output
        self.summary_stats_to_output = summary_stats_to_output

    def __call__(self, subjects):
        label_values = subjects[0][self.label_map_name]["label_values"]
        label_names = list(label_values.keys())
        subject_names = [s["name"] for s in subjects]

        subject_stats = LabeledTensor(
            dim_names=["subject", "label", "stat"],
            dim_keys=[subject_names, label_names, list(self.stats_to_output)])

        funcs = {"mean": np.mean, "std": lambda x: np.std(x, ddof=1) if x.size > 1 else 0.0,
                 "min": np.min, "max": np.max, "median": np.median}

        for subject in subjects:
            image = np.asarray(subject[self.image_name].data)
            labels = np.asarray(subject[self.label_map_name].data)
            for label_name, label_value in label_values.items():
                mask = labels == label_value
                values = image[np.broadcast_to(mask, image.shape)]
                for stat_name in self.stats_to_output:
                    value = float(funcs[stat_name](values)) if values.size else float("nan")
                    subject_stats[subject["name"], label_name, stat_name] = value

        summary_stats = subject_stats.compute_summary_stats(self.summary_stats_to_output)
        return {
            "subject_stats": subject_stats.to_table(),
            "summary_stats": summary_stats,
        }
