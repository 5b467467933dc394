"""nnUNet-style dataset fingerprint, ported from
segmentation_pipeline_tpu/data/dataset_fingerprint.py: per-subject spacing,
shape, label bounding boxes and intensity statistics, merged and
summarized, optionally saved to ``<root>/fingerprint/*.json``. Host code
only (numpy).
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..core.subject import LabelMap, ScalarImage
from ..utils.compact_json import CompactJSONEncoder
from .subject_folder import SubjectFolder


def get_bounds(mask: np.ndarray) -> dict:
    """Bounding-box summary of a boolean mask: per-axis extents, the crop
    margins to reach them, box size and center.

    Extents are inclusive voxel indices, size = max - min (one less than the voxel
    count), crop = (min, shape - max). An empty mask (a subject without that
    label — e.g. a healthy control with no lesion voxels) yields None
    instead of crashing the whole fingerprint run."""
    if not mask.any():
        return None
    coords = np.where(mask)
    lows = [int(c.min()) for c in coords]
    highs = [int(c.max()) for c in coords]
    return {
        "extents": [v for pair in zip(lows, highs) for v in pair],
        "crop": [v for axis, pair in enumerate(zip(lows, highs))
                 for v in (pair[0], mask.shape[axis] - pair[1])],
        "size": [hi - lo for lo, hi in zip(lows, highs)],
        "center": [(hi + lo) / 2 for lo, hi in zip(lows, highs)],
    }


def get_label_bounds(label_map: LabelMap) -> dict:
    label_bounds = {}
    label_values = label_map["label_values"]
    data = np.asarray(label_map.data)
    label_bounds["all"] = get_bounds(data[0] != 0)
    for label_name, label_value in label_values.items():
        label_bounds[label_name] = get_bounds(data[0] == label_value)
    # drop labels absent from this subject so the summary aggregates only
    # real boxes (merge/summarize would choke on Nones)
    return {k: v for k, v in label_bounds.items() if v is not None}


def get_summary_stats(values: np.ndarray, axis=None) -> dict:
    values = np.asarray(values)

    def item(x):
        x = np.asarray(x)
        if x.size > 1:
            return tuple(x.tolist())
        return x.item()

    return {
        "mean": item(np.mean(values.astype(np.float64), axis=axis)),
        "std": item(np.std(values.astype(np.float64), axis=axis, ddof=1)
                    if values.shape[0] > 1 or axis is None else np.zeros_like(values[0])),
        "median": item(np.median(values, axis=axis)),
        "min": item(np.min(values, axis=axis)),
        "max": item(np.max(values, axis=axis)),
    }


def merge_dict(in_dict: dict, out_dict: dict):
    for k, v in in_dict.items():
        if k not in out_dict:
            if isinstance(v, dict):
                out_dict[k] = {}
                merge_dict(v, out_dict[k])
            else:
                out_dict[k] = [v]
        else:
            if isinstance(v, dict):
                merge_dict(v, out_dict[k])
            else:
                out_dict[k].append(v)


def summarize(elem):
    if isinstance(elem, dict):
        return {k: summarize(v) for k, v in elem.items()}
    if isinstance(elem, list):
        return get_summary_stats(np.asarray(elem), axis=0)
    raise RuntimeError(f"Unexpected element {elem}")


def get_dataset_fingerprint(dataset: SubjectFolder, transform=None, save: bool = False,
                            image_names: Optional[Sequence[str]] = None):
    subject_fingerprints = {}
    for subject in dataset.all_subjects:
        # always work on a loaded deep copy: loading the pristine stored
        # subjects in place would pin the entire dataset in host RAM (and
        # mutate all_subjects) when transform is None
        subject = copy.deepcopy(subject)
        subject.load()
        if transform is not None:
            subject = transform(subject)

        if image_names is None:
            images = {k: v for k, v in subject.items() if isinstance(v, ScalarImage)}
            label_maps = {k: v for k, v in subject.items() if isinstance(v, LabelMap)}
        else:
            images = {n: subject[n] for n in image_names
                      if n in subject and isinstance(subject[n], ScalarImage)}
            label_maps = {n: subject[n] for n in image_names
                          if n in subject and isinstance(subject[n], LabelMap)}

        first = subject.get_first_image()
        subject_fingerprints[subject["name"]] = {
            "spacing": tuple(first.spacing),
            "spatial_shape": tuple(first.spatial_shape),
            "label_bounds": {name: get_label_bounds(lm) for name, lm in label_maps.items()},
            "intensity_stats": {name: get_summary_stats(np.asarray(img.data))
                                for name, img in images.items()},
        }

    fingerprints = list(subject_fingerprints.values())

    out_path = None
    if save:
        encoder = CompactJSONEncoder(indent=2)
        out_path = Path(dataset.root) / "fingerprint"
        out_path.mkdir(parents=True, exist_ok=True)
        with (out_path / "subject_fingerprints.json").open("w") as f:
            f.write(encoder.encode(subject_fingerprints))

    merged = {}
    for fingerprint in fingerprints:
        merge_dict(fingerprint, merged)
    summary_fingerprint = summarize(merged)

    if save:
        with (out_path / "fingerprint.json").open("w") as f:
            f.write(CompactJSONEncoder(indent=2).encode(summary_fingerprint))

    return subject_fingerprints, summary_fingerprint
