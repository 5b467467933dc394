"""Generate the dmri_hippo dataset splits as attribute JSONs.

Ported from research/dmri_hippo/make_dmri_hippo_splits.py: a stratified
53-subject cbbrain test split (age-binned, gender-balanced), 5 CV folds
over the remaining 100 labeled cbbrain subjects, and a stratified
50-subject unlabeled ab300 validation set. Host code only (the dataset is
read, no model is built).

    python -m segmentation_pipeline_torch.research.dmri_hippo.make_dmri_hippo_splits <dataset_path>
"""
import argparse
import json
from pathlib import Path

from segmentation_pipeline_torch import (
    ComposeFilters,
    ForbidAttributes,
    NegateFilter,
    RequireAttributes,
    StratifiedFilter,
)
from segmentation_pipeline_torch.utils.misc import random_folds

from .configs import main_config

OUTPUT_LABELS = ["whole_roi"]


def _healthy_single_scan(protocol: str) -> ComposeFilters:
    return ComposeFilters([
        RequireAttributes({"pathologies": "None", "rescan_id": "None"}),
        RequireAttributes({"protocol": protocol}),
    ])


def _stratified(size: int, seed: int) -> StratifiedFilter:
    return StratifiedFilter(size=size, continuous_attributes=["age"],
                            discrete_attributes=["gender"], seed=seed)


def _write_attribute_json(path: Path, mapping: dict):
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        json.dump(mapping, f, indent=4)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate dmri hippo splits.")
    parser.add_argument("dataset_path", type=str)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    # only the dataset is built: its definition holds no device
    context = main_config.get_context(device="cpu",
                                      variables=dict(DATASET_PATH=args.dataset_path))
    context.keep_components(("dataset",))
    context.init_components()
    dataset = context.dataset

    # labeled, healthy, single-scan cbbrain pool -> test + CV
    labeled_pool = dataset.get_cohort_dataset(ComposeFilters([
        RequireAttributes(OUTPUT_LABELS), _healthy_single_scan("cbbrain")]))
    test_filter = _stratified(size=53, seed=args.seed)
    test_set = labeled_pool.get_cohort_dataset(test_filter)
    cv_set = labeled_pool.get_cohort_dataset(NegateFilter(test_filter))
    assert len(test_set) == 53
    assert len(cv_set) == 100

    males = sum(1 for s in test_set.subjects if s["gender"] == "M")
    print(f"Testing males: {males}, females: {len(test_set) - males}")
    print(f"Testing ages: {sorted(s['age'] for s in test_set.subjects)}")

    fold_ids = random_folds(len(cv_set), num_folds=5, seed=args.seed)

    # unlabeled ab300 pool -> stratified validation set
    ab300_validation = dataset.get_cohort_dataset(ComposeFilters([
        ForbidAttributes(OUTPUT_LABELS), _healthy_single_scan("ab300"),
        _stratified(size=50, seed=args.seed)]))
    assert len(ab300_validation) == 50

    attributes_dir = Path(args.dataset_path) / "attributes"
    _write_attribute_json(
        attributes_dir / "cbbrain_test_subjects.json",
        {s["name"]: {"cbbrain_test": True} for s in test_set.subjects})
    _write_attribute_json(
        attributes_dir / "ab300_validation_subjects.json",
        {s["name"]: {"ab300_validation": True} for s in ab300_validation.subjects})
    _write_attribute_json(
        attributes_dir / "cross_validation_split.json",
        {s["name"]: {"fold": fold}
         for s, fold in zip(cv_set.subjects, fold_ids)})


if __name__ == "__main__":
    main()
