"""nnUNet interop: export a SubjectFolder dataset to the nnUNet raw layout.

Copied from segmentation_pipeline_tpu/utils/nn_unet_convert.py (host code):
imagesTr/labelsTr/imagesTs folders with <short_name>_<id:03>_<channel:04>.nii.gz
naming, dataset.json (modalities, labels with background, train/test
lists), original_subject_names.json, and optional CV splits (JSON and
splits_final.pkl with numpy arrays, the layout nnUNet_preprocessed
expects), so nnUNet can be trained on the same splits as an external check.
"""
from __future__ import annotations

import copy
import json
import pickle
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def save_dataset_as_nn_unet(
    cross_validation_dataset,
    output_path: str,
    short_name: str,
    image_names: Sequence[str],
    label_map_name: str,
    test_dataset: Optional[object] = None,
    metadata: dict = None,
    output_folds: bool = False,
    num_folds: int = None,
    image_names_to_save: Optional[Sequence[str]] = None,
):
    if output_folds:
        assert num_folds is not None, "Must specify number of cross validation folds."

    output_path = Path(output_path)
    train_image_path = output_path / "imagesTr"
    train_label_path = output_path / "labelsTr"
    test_image_path = output_path / "imagesTs"
    for folder in (train_image_path, train_label_path, test_image_path):
        folder.mkdir(parents=True, exist_ok=True)

    def save_images(image_path, subject_id, subject, name_cache, save_label_map):
        # Subject ids stay stable for partial exports (the id advances for
        # skipped subjects), but ONLY written subjects register in
        # name_cache: dataset.json/splits referencing never-written files
        # crash nnUNet preprocessing. image_names_to_save filters by
        # SUBJECT name, as the reference does, despite the parameter name.
        assert all(name in subject for name in image_names)
        new_name = f"{short_name}_{subject_id:03}"

        if image_names_to_save is not None and subject["name"] not in image_names_to_save:
            return
        name_cache[subject["name"]] = new_name

        channel_id = 0
        for image_name in image_names:
            image = subject[image_name]
            data = np.asarray(image.data)
            for c in range(data.shape[0]):
                out_image = copy.deepcopy(image)
                out_image.set_data(data[c:c + 1])
                out_file = image_path / f"{new_name}_{channel_id:04}.nii.gz"
                out_image.save(out_file)
                channel_id += 1

        if save_label_map:
            assert label_map_name in subject
            subject[label_map_name].save(train_label_path / f"{new_name}.nii.gz")

    subject_id = 1
    cv_names = {}
    for subject in cross_validation_dataset:
        save_images(train_image_path, subject_id, subject, cv_names, True)
        subject_id += 1

    test_names = {}
    if test_dataset is not None:
        for subject in test_dataset:
            save_images(test_image_path, subject_id, subject, test_names, False)
            subject_id += 1

    label_values = cross_validation_dataset[0][label_map_name]["label_values"]
    label_values = {"background": 0, **label_values}

    with (output_path / "dataset.json").open("w") as f:
        json.dump({
            "name": short_name,
            **(metadata or {}),
            "tensorImageSize": "4D",
            "modality": {str(i): name for i, name in enumerate(image_names)},
            "labels": {str(v): k for k, v in label_values.items()},
            "numTraining": len(cv_names),
            "numTest": len(test_names),
            "training": [
                {"image": f"./imagesTr/{name}.nii.gz",
                 "label": f"./labelsTr/{name}.nii.gz"}
                for name in cv_names.values()
            ],
            "test": [] if test_dataset is None else [
                f"./imagesTs/{name}.nii.gz" for name in test_names.values()
            ],
        }, f, indent=4)

    with (output_path / "original_subject_names.json").open("w") as f:
        json.dump({"cross_validation_subjects": cv_names,
                   "test_subjects": test_names}, f, indent=4)

    if output_folds:
        splits = [
            {
                "train": [cv_names[s["name"]]
                          for s in cross_validation_dataset.subjects
                          if s["fold"] != fold and s["name"] in cv_names],
                "val": [cv_names[s["name"]]
                        for s in cross_validation_dataset.subjects
                        if s["fold"] == fold and s["name"] in cv_names],
            }
            for fold in range(num_folds)
        ]
        with (output_path / "cross_validation_splits.json").open("w") as f:
            json.dump(splits, f, indent=4)
        # nnUNet_preprocessed wants OrderedDicts of numpy string arrays
        pickled = [OrderedDict({k: np.array(v) for k, v in s.items()})
                   for s in splits]
        with (output_path / "splits_final.pkl").open("wb") as f:
            pickle.dump(pickled, f)
