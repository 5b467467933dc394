"""MSSEG2 challenge inference: checkpoint(s) -> new-lesion mask on the raw grid.

Ported from research/msseg2/competition/ms_inference.py: patch-based
inference (96^3, overlap 48, edge padding), the full inverse back through
the history, hole removal (64) and small-component removal (3), the
resample onto the original image grid, and the NIfTI, with the JAX CLI's
arguments, defaults and file names. It runs on the card unless
``--device cpu`` (``device="cpu"``) asks for the CPU.

    python -m segmentation_pipeline_torch.research.msseg2.competition.ms_inference \
        <ensemble> <dataset> out.nii.gz [--device-argmax] [--device-postprocess] [--bf16] \
        [--device cpu]

With ``--device-postprocess`` the cleanup runs fused on the device, in
model space before the ids fetch (PatchPredict's ``device_postprocess``),
for each subject whose tape makes that order give the same voxels
(``_fused_cleanup_is_exact``); the others take the host cleanup after the
inversion, as without the flag.
"""
import argparse
from pathlib import Path

import numpy as np

from ....core.subject import Subject
from ....models.ensemble import EnsembleFlips, EnsembleModels, EnsembleOrientations
from ....post_processing import remove_holes, remove_small_components
from ....prediction import PatchPredict
from ....training.context import Context, list_checkpoint_files
from ....transforms.base import IntensityTransform, invert_records
from ....transforms.label import CustomOneHot
from ....transforms.spatial import resample_array
from ....transforms.structural import ConcatenateImages, RenameProperty

# the competition's cleanup chain, in order
CLEANUP_CHAIN = [("remove_holes", 64), ("remove_small_components", 3)]
CLEANUPS = {"remove_holes": remove_holes, "remove_small_components": remove_small_components}
PATCH_SIZE = 96


def _fused_cleanup_is_exact(subject) -> bool:
    """Whether the cleanup in model space (before the history inversion)
    gives the voxels of the cleanup after it: every invertible record's
    inverse must commute with the cleanup chain on y_pred. Intensity
    inverses touch intensity images only, ConcatenateImages and
    RenameProperty move whole images, and CustomOneHot's inverse argmax is
    the identity on exact one-hot ids; anything geometric (crops, pads,
    resamples) does not commute."""
    safe_classes = (ConcatenateImages, RenameProperty, CustomOneHot, IntensityTransform)
    for rec in subject.get_composed_history():
        t = rec.transform
        if not t.is_invertible():
            continue
        if isinstance(t, safe_classes):
            continue
        return False
    return True


def competition_predictor(device_argmax=False, device=None, device_postprocess=None):
    """The competition's predictor: 96^3 patches one at a time, an overlap
    of 48, edge padding, averaged overlaps; with ``device_postprocess`` (a
    cleanup chain) the fused predictor, which argmaxes and cleans on the
    device."""
    return PatchPredict(patch_batch_size=1, patch_size=PATCH_SIZE, patch_overlap=PATCH_SIZE // 2,
                        padding_mode="edge", overlap_mode="average", image_names=["X"],
                        device_argmax=device_argmax or bool(device_postprocess),
                        device_postprocess=device_postprocess, device=device)


def ms_to_raw_grid(subject, raw_subject, cleanup=True):
    """The steps after the prediction: invert the tape on y_pred, argmax,
    run CLEANUP_CHAIN (unless ``cleanup`` is False: the predictor cleaned
    on the device), resample (order 0) onto the raw first image's grid,
    int32. Returns the label map on the raw grid and the voxels each
    cleanup removed (empty without the host cleanup)."""
    pred_subject = Subject({"y": subject["y_pred"]})
    pred_subject = invert_records(pred_subject, subject.get_composed_history(), warn=False)
    output_label = pred_subject.get_first_image()
    data = np.asarray(output_label.data)
    label_data = (np.argmax(data, axis=0) if data.shape[0] > 1 else data[0]).astype(np.int32)
    report = []
    for op, arg in CLEANUP_CHAIN if cleanup else ():
        label_data, removed = CLEANUPS[op](label_data, arg)
        report.append(removed)
    output_label.set_data(label_data[None].astype(np.int32))

    target_image = raw_subject.get_first_image()
    target_image.load()
    data = resample_array(np.asarray(output_label.data).astype(np.float32), output_label.affine,
                          target_image.affine, target_image.spatial_shape, order=0)
    output_label.set_data(np.rint(data).astype(np.int32))
    output_label.affine = target_image.affine.copy()
    if output_label.spatial_shape != target_image.spatial_shape:
        raise RuntimeError("Segmentation shape and original image shape do not match.")
    return output_label, report


def ms_inference(subject, raw_subject, model, predictor):
    """Predict one transformed subject, then bring its mask back to the raw
    grid (``ms_to_raw_grid``; the host cleanup only where the predictor did
    not clean on the device)."""
    [subject], _ = predictor.predict(model, [subject])
    return ms_to_raw_grid(subject, raw_subject, cleanup=not predictor.device_postprocess)


def inference(dataset, model, out_folder, output_filename,
              device_argmax=False, device_postprocess=False, device=None):
    """Serve every subject of ``dataset`` into its NIfTI. Returns
    [(subject name, "fused" or "host"), ...]: where each one's cleanup ran."""
    predictor = competition_predictor(device_argmax, device)
    # the host chain and the fused one come from the same CLEANUP_CHAIN
    fused_predictor = competition_predictor(True, device, device_postprocess=CLEANUP_CHAIN)
    paths = []

    for i in range(len(dataset)):
        subject = dataset[i]
        untransformed_subject = dataset.subjects[i]
        print(f"Running model for subject {subject['name']}")

        folder = Path(subject["folder"]) if out_folder == "" else \
            Path(out_folder) / subject["name"]
        folder.mkdir(exist_ok=True, parents=True)

        # the fused path only where it gives the voxels of the cleanup after
        # the inversion
        fused = bool(device_postprocess) and _fused_cleanup_is_exact(subject)
        if device_postprocess and not fused:
            print("device-postprocess: history has a spatial/label inverse; "
                  "falling back to the host cleanup for exact parity")
        output_label, report = ms_inference(subject, untransformed_subject, model,
                                            fused_predictor if fused else predictor)
        if fused:
            print("Cleanup ran fused on device (holes filled + small "
                  "components removed before the ids fetch).")
        for (op, arg), removed in zip(CLEANUP_CHAIN, report):
            if op == "remove_holes":
                print(f"Filled {removed} voxels from detected holes.")
            else:
                print(f"Removed {removed} voxels from small predictions less than size {arg}.")
        output_label.save(folder / output_filename)
        paths.append((subject["name"], "fused" if fused else "host"))
    return paths


def load_contexts(ensemble_path, dataset_path, ensemble_orientations="", ensemble_folds=False,
                  bf16=False, device=None):
    """One context per checkpoint file; under ensemble_folds only the
    first keeps its dataset."""
    contexts = []
    for i, file_path in enumerate(list_checkpoint_files(Path(ensemble_path))):
        context = Context(device, file_path=file_path,
                          variables=dict(DATASET_PATH=str(dataset_path)))
        keep = ("model", "dataset") if (i == 0 or not ensemble_folds) else ("model",)
        context.keep_components(keep)
        context.init_components()
        if bf16 and getattr(context.model, "compute_dtype", "absent") is None:
            context.model.compute_dtype = "bfloat16"
        if ensemble_orientations == "orientations":
            context.model = EnsembleOrientations(context.model, strategy="majority")
        if ensemble_orientations == "flips":
            context.model = EnsembleFlips(context.model, strategy="majority")
        contexts.append(context)
    return contexts


def build_parser():
    parser = argparse.ArgumentParser(description="MSSEG2 new-lesion segmentation")
    parser.add_argument("ensemble_path")
    parser.add_argument("dataset_path")
    parser.add_argument("output_filename")
    parser.add_argument("--out-folder", default="")
    parser.add_argument("--ensemble-orientations", default="",
                        choices=["", "flips", "orientations"])
    parser.add_argument("--ensemble-folds", action="store_true")
    parser.add_argument("--cohort", default=None)
    parser.add_argument("--device-argmax", action="store_true",
                        help="argmax on the device and fetch the label ids instead of the "
                             "float32 probability volume (the same mask)")
    parser.add_argument("--device-postprocess", action="store_true",
                        help="run the hole-fill + small-component cleanup fused on the device "
                             "before the ids fetch (implies --device-argmax; a subject whose "
                             "history makes the fused order inexact takes the host cleanup)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 forward (float32 weights); omit for float32")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' for the CPU)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    contexts = load_contexts(args.ensemble_path, args.dataset_path,
                             args.ensemble_orientations, args.ensemble_folds, args.bf16,
                             args.device)
    print("Loaded models.")

    if args.ensemble_folds:
        context = contexts[0]
        context.model = EnsembleModels([c.model for c in contexts], strategy="majority")
        contexts = [context]

    for i, context in enumerate(contexts):
        dataset = (context.dataset if args.cohort is None
                   else context.dataset.get_cohort_dataset(args.cohort))
        print(f"Running evaluation for context {i}")
        # --device-postprocess implies --device-argmax: the subjects that
        # take the host cleanup fetch label ids too
        inference(dataset, context.model, args.out_folder, args.output_filename,
                  device_argmax=args.device_argmax or args.device_postprocess,
                  device_postprocess=args.device_postprocess, device=args.device)


if __name__ == "__main__":
    main()
