"""Export the dmri_hippo dataset to nnUNet raw format (an external check).

Ported from research/dmri_hippo/nn_unet/convert_dataset.py, with the
SaggitalSplitWrapper that splits each subject into mirrored hemispheres.
Host code only (the dataset is read, no model is built).

    python -m segmentation_pipeline_torch.research.dmri_hippo.nn_unet.convert_dataset \
        <dataset> <out> [--split-and-mirror] [--task-name Task501_hippo]
"""
import argparse
import copy

from segmentation_pipeline_torch import (
    Compose,
    Crop,
    CropOrPad,
    CustomRemapLabels,
    EnforceConsistentAffine,
    Flip,
    NegateFilter,
    SubjectFolder,
)
from segmentation_pipeline_torch.utils.nn_unet_convert import save_dataset_as_nn_unet

from ..configs.main_config import get_context


class SaggitalSplitWrapper:
    """Doubles the dataset: each subject becomes a left and a mirrored right
    hemisphere."""

    def __init__(self, dataset: SubjectFolder, half_width: int = 48):
        self.dataset = dataset
        self.half_width = half_width
        self.subjects = []
        for subject in dataset.subjects:
            left = copy.deepcopy(subject)
            right = copy.deepcopy(subject)
            left["name"] = f"{subject['name']}_left"
            right["name"] = f"{subject['name']}_right"
            self.subjects += [left, right]

    def __len__(self):
        return len(self.subjects)

    def __getitem__(self, idx):
        subject = copy.deepcopy(self.subjects[idx])
        subject.load()
        subject = self.dataset.transform(subject)
        h = self.half_width
        if subject["name"].endswith("left"):
            subject = Crop(cropping=(h, 0, 0, 0, 0, 0))(subject)
        elif subject["name"].endswith("right"):
            subject = Crop(cropping=(0, h, 0, 0, 0, 0))(subject)
            subject = Flip(axes=(0,))(subject)
        else:
            raise RuntimeError()
        return subject


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset_path")
    parser.add_argument("output_path")
    parser.add_argument("--task-name", default="Task501_hippo")
    parser.add_argument("--split-and-mirror", action="store_true")
    args = parser.parse_args(argv)

    context = get_context(device="cpu", variables=dict(DATASET_PATH=args.dataset_path))
    context.keep_components(("dataset",))
    context.init_components()

    dataset = context.dataset
    cv_filter = dataset.cohorts["cross_validation"]
    test_filter = NegateFilter(cv_filter)
    cv_dataset = dataset.get_cohort_dataset(cv_filter)
    test_dataset = dataset.get_cohort_dataset(test_filter)

    if args.split_and_mirror:
        transform = Compose([
            EnforceConsistentAffine(),
            CropOrPad((96, 88, 20), padding_mode="minimum",
                      mask_name="whole_roi_union"),
            CustomRemapLabels(remapping=[("right_whole", 2, 1)],
                              masking_method="Right", include=["whole_roi"]),
        ])
        cv_dataset.set_transform(transform)
        test_dataset.set_transform(transform)
        cv_dataset = SaggitalSplitWrapper(cv_dataset)
        test_dataset = SaggitalSplitWrapper(test_dataset)
    else:
        cv_dataset.set_transform(EnforceConsistentAffine())
        test_dataset.set_transform(EnforceConsistentAffine())

    save_dataset_as_nn_unet(
        cv_dataset, args.output_path, args.task_name,
        image_names=["mean_dwi", "md", "fa"], label_map_name="whole_roi",
        test_dataset=test_dataset, output_folds=True, num_folds=5)


if __name__ == "__main__":
    main()
