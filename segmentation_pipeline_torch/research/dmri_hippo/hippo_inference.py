"""dmri_hippo inference CLI: checkpoints -> predictions on the scanner grid.

Ported from research/dmri_hippo/hippo_inference.py: loads one or more
context checkpoints (fold ensemble, flip and/or affine TTA), predicts, inverts the
whole history tape back to the original scanner grid, post-processes (hole
removal and component keeping), and saves NIfTIs, a report and a settings
JSON, with the JAX CLI's arguments, defaults, file names and contents. It
runs on the card unless ``--device cpu`` (``device="cpu"``) asks for the
CPU.

    python -m segmentation_pipeline_torch.research.dmri_hippo.hippo_inference \
        <ensemble_dir> <dataset> <run_name> [--ensemble-flips] [--ensemble-folds] \
        [--ensemble-affines N] [--batched-tta] [--bf16] [--cohort X] [--out-folder OUT] \
        [--device cpu]

``--tta-mesh`` raises before any work, naming the ROADMAP item that brings
it.
"""
import argparse
import json
from pathlib import Path

import numpy as np

from ...core.subject import Subject
from ...models.ensemble import EnsembleAffines, EnsembleFlips, EnsembleModels
from ...post_processing import keep_components, remove_holes
from ...training.context import Context, list_checkpoint_files
from ...training.trainer import _not_ported
from ...transforms.base import invert_records


def invert_predictions(subjects):
    """Invert each subject's ``y_pred`` through its tape back to the
    original scanner grid, as int32 labels with the original affine."""
    for subject in subjects:
        pred_subject = Subject({"y": subject["y_pred"]})
        pred_subject = invert_records(pred_subject, subject.get_composed_history(), warn=False)
        output_label = pred_subject.get_first_image()
        subject["y_pred"].set_data(np.asarray(output_label.data).astype(np.int32))
        subject["y_pred"].affine = output_label.affine
    return subjects


def inference(subjects, predictor, model):
    subject_names = [s["name"] for s in subjects]
    print(f"running inference for subjects: {subject_names}")
    subjects, _ = predictor.predict(model=model, subjects=subjects)
    return invert_predictions(subjects)


def post_process(output_label):
    """Fill holes of up to 64 voxels, then keep as many components as the
    largest label; returns the report text."""
    label_data = np.asarray(output_label.data)[0]

    label_data, hole_voxels_removed = remove_holes(label_data, hole_size=64)
    txt_output = f"Filled {hole_voxels_removed} voxels from detected holes.\n"

    num_components = int(label_data.max())
    label_data, num_components_removed, num_elements_removed = keep_components(
        label_data, num_components)
    txt_output += (f"Removed {num_elements_removed} voxels from "
                   f"{num_components_removed} components.")

    output_label.set_data(label_data[None].astype(np.int32))
    return txt_output


def generate_file_name(context, output_name):
    if output_name is None:
        name = context.name
        return name if isinstance(name, str) else "-".join(map(str, name))
    return Path(output_name).stem


def save_subjects_predictions(subjects, out_folder, output_filename):
    for subject in subjects:
        if out_folder == "":
            out_path = Path(subject["folder"])
        else:
            out_path = Path(out_folder) / "subjects" / subject["name"]
        out_path.mkdir(exist_ok=True, parents=True)
        subject["y_pred"].save(out_path / (output_filename + ".nii.gz"))


def post_process_subjects(subjects, image_name):
    txt_output = ""
    for subject in subjects:
        txt_output += subject["name"] + "\n"
        txt_output += post_process(subject[image_name]) + "\n"
    return txt_output


def load_contexts(ensemble_path, dataset_path, ensemble_flips=False, batched_tta=False,
                  bf16=False, device=None, ensemble_affines=0):
    """One context per checkpoint file, with its model, trainer and
    dataset, the model wrapped in flip TTA and then in affine TTA of
    ``ensemble_affines`` members when asked."""
    contexts = []
    for file_path in list_checkpoint_files(Path(ensemble_path)):
        context = Context(device, file_path=file_path,
                          variables=dict(DATASET_PATH=str(dataset_path)))
        context.keep_components(("model", "trainer", "dataset"))
        context.init_components()
        if bf16 and getattr(context.model, "compute_dtype", "absent") is None:
            # the network runs in bfloat16 over float32 weights
            context.model.compute_dtype = "bfloat16"
        if ensemble_flips:
            context.model = EnsembleFlips(context.model, strategy="majority",
                                          spatial_dims=(3, 4), batched=batched_tta)
        if ensemble_affines:
            # composes with flip TTA when both are asked for
            context.model = EnsembleAffines(context.model, num_members=ensemble_affines,
                                            scales=0.1, degrees=10, strategy="majority",
                                            batched=batched_tta)
        contexts.append(context)
    return contexts


def main(ensemble_path, dataset_path, run_name, output_filename=None, out_folder="",
         ensemble_flips=False, ensemble_folds=False, cohort=None, num_workers=0,
         batch_size=4, batched_tta=False, tta_mesh=False, ensemble_affines=0,
         bf16=False, device=None):
    if tta_mesh:
        raise _not_ported("--tta-mesh (flip TTA sharded over devices)", "item 10 (multi-device)")
    input_args = dict(ensemble_path=str(ensemble_path), dataset_path=str(dataset_path),
                      run_name=run_name, output_filename=output_filename,
                      out_folder=str(out_folder), ensemble_flips=ensemble_flips,
                      ensemble_folds=ensemble_folds, cohort=str(cohort),
                      num_workers=num_workers, batch_size=batch_size,
                      batched_tta=batched_tta, tta_mesh=tta_mesh,
                      ensemble_affines=ensemble_affines, bf16=bf16)

    contexts = load_contexts(ensemble_path, dataset_path, ensemble_flips, batched_tta, bf16,
                             device, ensemble_affines)
    print("Loaded models.")

    if ensemble_folds:
        context = contexts[0]
        models = [c.model for c in contexts]
        context.model = EnsembleModels(models, strategy="majority")
        context.name = [c.name for c in contexts]
        contexts = [context]

    for context in contexts:
        dataset = (context.dataset if cohort is None
                   else context.dataset.get_cohort_dataset(cohort))
        print(f"Running inference for context {context.name}")

        dataloader = context.trainer.validation_dataloader_factory.get_data_loader(
            dataset=dataset, batch_size=batch_size, num_workers=num_workers)

        base_file_name = generate_file_name(context, output_filename)
        report_path = Path(out_folder) / (base_file_name + ".txt")
        # truncated once per run, then appended per batch
        report_path.write_text("")
        for subjects in dataloader:
            subjects = inference(subjects, context.trainer.validation_predictor,
                                 context.model)
            save_subjects_predictions(subjects, out_folder,
                                      base_file_name + "_before_processing")
            txt_output = post_process_subjects(subjects, "y_pred")
            print(txt_output)
            with open(report_path, "a") as f:
                f.write(txt_output)
            save_subjects_predictions(subjects, out_folder, base_file_name)

    base_file_name = generate_file_name(contexts[-1], output_filename)
    with open(Path(out_folder) / (run_name + ".json"), "w") as f:
        settings = dict(input_args)
        settings["context_name"] = [c.name for c in contexts]
        settings["output_filename"] = base_file_name + ".nii.gz"
        json.dump(settings, f, indent=4)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ensemble_path")
    parser.add_argument("dataset_path")
    parser.add_argument("run_name")
    parser.add_argument("--output-filename", default=None)
    parser.add_argument("--out-folder", default="")
    parser.add_argument("--ensemble-flips", action="store_true")
    parser.add_argument("--ensemble-folds", action="store_true")
    parser.add_argument("--ensemble-affines", type=int, default=0,
                        help="affine-TTA member count (0 = off)")
    parser.add_argument("--cohort", default=None)
    parser.add_argument("--num-workers", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--batched-tta", action="store_true",
                        help="fold TTA members into one forward")
    parser.add_argument("--tta-mesh", action="store_true",
                        help="shard the folded TTA batch over devices (not ported yet)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 forward (float32 weights); omit for float32")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' for the CPU)")
    return parser


if __name__ == "__main__":
    a = build_parser().parse_args()
    main(a.ensemble_path, a.dataset_path, a.run_name, a.output_filename,
         a.out_folder, a.ensemble_flips, a.ensemble_folds, a.cohort,
         a.num_workers, a.batch_size, a.batched_tta, a.tta_mesh,
         a.ensemble_affines, bf16=a.bf16, device=a.device)
