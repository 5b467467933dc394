"""Offline evaluation of saved predictions against ground truth.

Ported from research/dmri_hippo/evaluate.py: loads the ground truth
SubjectFolder with test/validation cohort modes, attaches each saved
prediction run via load_additional_data, runs the LabelMap and
Segmentation evaluators per cohort, and writes the results as JSON, equal
to the JAX CLI's. Host code only; pandas is imported when the results are
made plain.

    python -m segmentation_pipeline_torch.research.dmri_hippo.evaluate \
        <ground_truth> <predictions> --cohort-mode validation --out results.json
"""
import argparse
import json
import warnings
from glob import glob
from pathlib import Path

import numpy as np

from segmentation_pipeline_torch import (
    AttributeLoader,
    ComposeFilters,
    ComposeLoaders,
    ForbidAttributes,
    ImageLoader,
    LabelMap,
    LabelMapEvaluator,
    RequireAttributes,
    ScalarImage,
    ScheduledEvaluation,
    SegmentationEvaluator,
    SubjectFolder,
)
from segmentation_pipeline_torch.evaluators.labeled_tensor import LabeledTensor, Table


def load_config_files(path):
    configs = {}
    for config_file in glob(f"{path}/*.json"):
        with open(config_file) as f:
            configs[Path(config_file).stem] = json.load(f)
    return configs


def to_plain(elem):
    """Evaluator results as JSON-ready values: a Table as the records of
    its DataFrame (as the JAX CLI writes its DataFrames), a LabeledTensor
    as its dict."""
    if isinstance(elem, dict):
        return {k: to_plain(v) for k, v in elem.items()}
    if isinstance(elem, Table):
        return json.loads(elem.to_dataframe().to_json(orient="records"))
    if isinstance(elem, LabeledTensor):
        return elem.to_dict()
    return elem


def get_cohorts(cohort_mode):
    cohorts = {}
    if cohort_mode == "test":
        cohorts["cbbrain_test"] = RequireAttributes(
            {"protocol": "cbbrain", "rescan_id": "None", "cbbrain_test": True})
        cohorts["ab300_test"] = ComposeFilters([
            RequireAttributes({"protocol": "ab300", "rescan_id": "None"}),
            ForbidAttributes({"ab300_validation": True}),
            RequireAttributes(["y"]),
        ])
        cohorts["rescans"] = ForbidAttributes({"rescan_id": "None"})
        cohorts["ab300_unlabeled"] = ComposeFilters([
            RequireAttributes({"protocol": "ab300", "rescan_id": "None"}),
            ForbidAttributes({"ab300_validation": True}),
            ForbidAttributes(["y"]),
        ])
    elif cohort_mode == "validation":
        cohorts["cbbrain_validation"] = ComposeFilters([
            RequireAttributes({"protocol": "cbbrain"}), RequireAttributes(["fold"])])
        cohorts["ab300_validation"] = RequireAttributes(
            {"protocol": "ab300", "ab300_validation": True})
    else:
        raise ValueError("Invalid mode provided. Must be 'validation' or 'test'")
    return cohorts


def main(ground_truth_path, predictions_path, cohort_mode="validation", out=None):
    subject_loader = ComposeLoaders([
        ImageLoader(glob_pattern="whole_roi.*", image_name="y",
                    image_constructor=LabelMap,
                    label_values={"left_whole": 1, "right_whole": 2}),
        ImageLoader(glob_pattern="mean_dwi.*", image_name="mean_dwi",
                    image_constructor=ScalarImage),
        AttributeLoader(glob_pattern="attributes.*"),
        AttributeLoader(glob_pattern="../../attributes/cross_validation_split.json",
                        multi_subject=True, uniform=True),
        AttributeLoader(glob_pattern="../../attributes/ab300_validation_subjects.json",
                        multi_subject=True, uniform=True),
        AttributeLoader(glob_pattern="../../attributes/cbbrain_test_subjects.json",
                        multi_subject=True, uniform=True),
    ])

    cohorts = get_cohorts(cohort_mode)
    subjects = SubjectFolder(root=ground_truth_path, subject_path="subjects",
                             subject_loader=subject_loader, cohorts=cohorts)

    configs = load_config_files(predictions_path)

    curve_params = {
        "left_whole": np.array([-1.96312119e-01, 9.46668029e00, 2.33635173e03]),
        "right_whole": np.array([-2.68467331e-01, 1.67925603e01, 2.07224236e03]),
    }
    evaluators = [
        ScheduledEvaluation(
            evaluator=LabelMapEvaluator(
                "y_pred", curve_params=curve_params, curve_attribute="age",
                stats_to_output=("volume", "error", "absolute_error",
                                 "squared_error", "percent_diff")),
            log_name="predicted_label_eval",
            cohorts=["cbbrain_validation", "ab300_validation", "cbbrain_test",
                     "ab300_test", "ab300_unlabeled"]),
        ScheduledEvaluation(
            evaluator=SegmentationEvaluator("y_pred", "y"),
            log_name="segmentation_eval",
            cohorts=["cbbrain_validation", "cbbrain_test", "ab300_test"]),
    ]

    all_results = {}
    for name, config in configs.items():
        pred_loader = ImageLoader(glob_pattern=f"{config['output_filename']}",
                                  image_name="y_pred", image_constructor=LabelMap,
                                  label_values={"left_whole": 1, "right_whole": 2})
        subjects.load_additional_data(str(Path(predictions_path) / "subjects"),
                                      pred_loader)

        log_data = {}
        for scheduled in evaluators:
            valid_cohorts = [c for c in scheduled.cohorts if c in subjects.cohorts]
            for cohort in valid_cohorts:
                cohort_subjects = subjects.cohorts[cohort](subjects.subjects)
                subjects_eval = [s for s in cohort_subjects if "y_pred" in s]
                if len(cohort_subjects) > len(subjects_eval):
                    warnings.warn(
                        f"Some subjects in cohort '{cohort}' are missing predictions",
                        RuntimeWarning)
                if subjects_eval:
                    for s in subjects_eval:
                        s.load()
                    results = scheduled.evaluator(subjects_eval)
                    log_data[f"{scheduled.log_name}/{cohort}"] = results

        all_results[name] = to_plain(log_data)
        print(f"evaluated run {name}: "
              f"{sorted(all_results[name].keys())}")

        for subject in subjects.subjects:
            if "y_pred" in subject:
                del subject["y_pred"]

    if out:
        with open(out, "w") as f:
            json.dump(all_results, f, indent=2, default=str)
    return all_results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ground_truth_path")
    parser.add_argument("predictions_path")
    parser.add_argument("--cohort-mode", default="validation",
                        choices=["validation", "test"])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    main(args.ground_truth_path, args.predictions_path, args.cohort_mode, args.out)
