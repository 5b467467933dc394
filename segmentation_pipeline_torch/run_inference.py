"""Packaged hippocampus inference with orientation TTA.

Ported from run_inference.py: load checkpoint(s), strip TargetResample from
the preprocessing pipeline, run each subject under all 48 orientations (6
permutations x 8 flips), invert each prediction back, take the voxelwise
majority, remove holes, resample onto the original grid and save, with the
JAX CLI's arguments, defaults and file names. It runs on the card unless
``--device cpu`` asks for the CPU.

    python -m segmentation_pipeline_torch.run_inference <checkpoint_or_dir> <dataset> \
        out.nii.gz [--patch] [--orientation-count 48] [--device cpu]
"""
import argparse
import copy
import itertools
from pathlib import Path

import numpy as np

from .core.nifti import write_nifti
from .core.subject import Subject
from .models.ensemble import EnsembleModels
from .post_processing import remove_holes
from .prediction import PatchPredict, StandardPredict
from .training.context import Context, list_checkpoint_files
from .transforms.base import Compose, filter_transform, invert_records
from .transforms.spatial import Flip, TargetResample, resample_array
from .transforms.structural import PermuteDimensions


def get_test_time_transforms():
    """All 48 orientation transforms: 6 spatial permutations x 8 flip
    combinations, permutation-major."""
    transforms = []
    for permutation in itertools.permutations((0, 1, 2)):
        for order in range(4):
            for flip_axes in itertools.combinations((0, 1, 2), order):
                ops = [PermuteDimensions(permutation)]
                if flip_axes:
                    ops.append(Flip(flip_axes))
                transforms.append(Compose(ops))
    return transforms


def test_time_augmentation(subject, predictor, model, orientation_count=48):
    """Predict under each orientation, invert back, voxelwise mode vote."""
    predictions = []
    for tta_transform in get_test_time_transforms()[:orientation_count]:
        aug_subject = tta_transform(copy.deepcopy(subject))

        [aug_subject], _ = predictor.predict(model, [aug_subject])

        # invert the C-channel prediction first: a pipeline ending in
        # CustomOneHot(include=['y']) records an inverse CustomArgMax that
        # argmaxes during the inversion, and argmaxing before it would leave
        # a single-channel map whose second argmax zeroes everything
        pred_subject = Subject({"y": copy.deepcopy(aug_subject["y_pred"])})
        pred_subject = invert_records(pred_subject, aug_subject.get_composed_history(),
                                      warn=False)
        pred = np.asarray(pred_subject.get_first_image().data)
        if pred.shape[0] > 1:  # no CustomOneHot in the history: argmax here
            pred = np.argmax(pred, axis=0)[None]
        predictions.append(pred.astype(np.int32))

    stacked = np.stack(predictions)  # (T, 1, W, H, D)
    flat = stacked.reshape(stacked.shape[0], -1)
    n_classes = int(flat.max()) + 1
    counts = np.stack([(flat == c).sum(axis=0) for c in range(n_classes)])
    mode = np.argmax(counts, axis=0).reshape(stacked.shape[1:])
    return mode.astype(np.int32)


def load_contexts(checkpoint_path, dataset_path, device=None):
    """One context per checkpoint file; only the first keeps its dataset."""
    contexts = []
    for i, file_path in enumerate(list_checkpoint_files(Path(checkpoint_path))):
        context = Context(device, file_path=str(file_path),
                          variables=dict(DATASET_PATH=str(dataset_path)))
        context.keep_components(("model", "dataset") if i == 0 else ("model",))
        context.init_components()
        contexts.append(context)
    return contexts


def build_parser():
    parser = argparse.ArgumentParser(description="Auto Hippocampus Segmentation")
    parser.add_argument("checkpoint_path", help="Checkpoint file or folder of checkpoints")
    parser.add_argument("dataset_path")
    parser.add_argument("output_filename")
    parser.add_argument("--out-folder", default="")
    parser.add_argument("--patch", action="store_true",
                        help="Use sliding-window patch inference")
    parser.add_argument("--patch-size", type=int, default=96)
    parser.add_argument("--patch-overlap", type=int, default=48)
    parser.add_argument("--orientation-count", type=int, default=48)
    parser.add_argument("--cohort", default=None)
    parser.add_argument("--device-argmax", action="store_true",
                        help="argmax on the device; fetch the label ids per orientation "
                             "instead of float32 probabilities (the same vote)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' for the CPU)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    contexts = load_contexts(args.checkpoint_path, args.dataset_path, args.device)
    context = contexts[0]
    if len(contexts) > 1:
        context.model = EnsembleModels([c.model for c in contexts], strategy="mean")

    dataset = (context.dataset if args.cohort is None
               else context.dataset.get_cohort_dataset(args.cohort))

    # inference runs in the subject's native spacing
    if dataset.transform is not None:
        dataset.transform = filter_transform(dataset.transform,
                                             exclude_types=[TargetResample])

    if args.patch:
        predictor = PatchPredict(patch_batch_size=1, patch_size=args.patch_size,
                                 patch_overlap=args.patch_overlap,
                                 overlap_mode="average", image_names=["X"],
                                 device_argmax=args.device_argmax, device=args.device)
    else:
        predictor = StandardPredict(image_names=["X"], device_argmax=args.device_argmax,
                                    device=args.device)

    for i in range(len(dataset)):
        subject = dataset[i]
        original = dataset.subjects[i]
        print(f"Running TTA inference for subject {subject['name']}")

        label_data = test_time_augmentation(subject, predictor, context.model,
                                            args.orientation_count)

        label_data, holes = remove_holes(label_data[0], hole_size=64)
        print(f"Filled {holes} voxels from detected holes.")
        label_data = label_data[None]

        # resample back onto the original subject grid if the shapes differ
        target_image = original.get_first_image()
        target_image.load()
        pred_affine = subject.get_first_image().affine
        if tuple(label_data.shape[1:]) != tuple(target_image.spatial_shape):
            label_data = resample_array(label_data.astype(np.float32), pred_affine,
                                        target_image.affine,
                                        target_image.spatial_shape, order=0)
            label_data = np.rint(label_data).astype(np.int32)

        out_folder = (Path(original["folder"]) if args.out_folder == ""
                      else Path(args.out_folder) / subject["name"])
        out_folder.mkdir(exist_ok=True, parents=True)
        write_nifti(out_folder / args.output_filename, label_data, target_image.affine)


if __name__ == "__main__":
    main()
