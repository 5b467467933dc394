"""MSSEG2 challenge entry point: two FLAIRs in, lesion mask out.

Ported from research/msseg2/competition/ms_run.py: stages the two
timepoints into the expected folder layout, runs the (optional) Anima
longitudinal preprocessing if given, then the port's ms_inference in a
subprocess, and copies the result to the requested output path.

    python -m segmentation_pipeline_torch.research.msseg2.competition.ms_run \
        -t1 a.nii.gz -t2 b.nii.gz -o out.nii.gz --ensemble-path saved_models/ensemble
"""
import argparse
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from segmentation_pipeline_torch.core.nifti import read_nifti, write_nifti

INFERENCE_MODULE = "segmentation_pipeline_torch.research.msseg2.competition.ms_inference"


def _suffix(path):
    """read_nifti picks gzip by extension, so a staged copy keeps it."""
    return ".nii.gz" if str(path).endswith(".gz") else ".nii"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Detect new MS lesions from two FLAIR images.")
    parser.add_argument("-t1", "--time01", required=True,
                        help="First time step (path to the FLAIR image).")
    parser.add_argument("-t2", "--time02", required=True,
                        help="Second time step (path to the FLAIR image).")
    parser.add_argument("-o", "--output", required=True,
                        help="Path of the output segmentation.")
    parser.add_argument("-d", "--data-folder", default="data/")
    parser.add_argument("--ensemble-path", required=True,
                        help="Folder of context checkpoints.")
    parser.add_argument("--anima-preprocess", default=None,
                        help="Path to animaMSLongitudinalPreprocessing.py "
                             "(skipped when not given).")
    parser.add_argument("--device", default=None,
                        help="torch device for the inference (default: the card)")
    args = parser.parse_args(argv)

    data_folder = Path(args.data_folder)
    input_folder = data_folder / "input" / "raw_data"
    subject_folder = input_folder / "01"
    subject_folder.mkdir(exist_ok=True, parents=True)
    shutil.copy(args.time01,
                subject_folder / f"flair_time01_on_middle_space{_suffix(args.time01)}")
    shutil.copy(args.time02,
                subject_folder / f"flair_time02_on_middle_space{_suffix(args.time02)}")

    output_folder = data_folder / "output"
    output_folder.mkdir(exist_ok=True, parents=True)

    if args.anima_preprocess:
        processed = data_folder / "input" / "processed"
        processed.mkdir(exist_ok=True, parents=True)
        subprocess.run([sys.executable, args.anima_preprocess,
                        "-i", str(input_folder), "-o", str(processed)], check=True)
        inference_input = processed
    else:
        # without Anima, a brain mask covering the volume makes CropToMask a no-op
        data, affine = read_nifti(
            subject_folder / f"flair_time01_on_middle_space{_suffix(args.time01)}")
        write_nifti(subject_folder / "brain_mask.nii.gz",
                    np.ones_like(data, dtype=np.int16), affine)
        inference_input = input_folder

    device = ["--device", args.device] if args.device else []
    subprocess.run([sys.executable, "-m", INFERENCE_MODULE,
                    str(args.ensemble_path), str(inference_input), "temp.nii.gz",
                    "--out-folder", str(output_folder), *device], check=True)

    shutil.copy(output_folder / "01" / "temp.nii.gz", args.output)


if __name__ == "__main__":
    main()
