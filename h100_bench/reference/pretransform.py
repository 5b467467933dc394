"""dmri_hippo's deterministic preprocessing (``main_config.py``: NaN to 0,
crop or pad to the crop around the atlas union mask's bounding box, padding
with each image's minimum, left and right hippocampus as one label in
each hemisphere, then the model-io rescale of each image to [-1, 1]
between its 0.5th and 99.5th percentiles) of the benchmark's raw volumes,
in numpy: the training set as the trainer's device cache holds it. (The
fast path keeps the model-io rescale on the host and applies it again
after the device augmentation.)"""
from __future__ import annotations

import numpy as np


def crop_or_pad(volume: np.ndarray, center, target) -> np.ndarray:
    """(C, W, H, D) -> (C, *target): the window of ``target`` centred on
    ``center`` (rounded half to even); where it leaves the volume, the
    minimum of what was cut from the volume."""
    index, pad = [slice(None)], [(0, 0)]
    for c, t, size in zip(center, target, volume.shape[1:]):
        lo = int(round(c - t / 2 + 0.5))
        index.append(slice(max(lo, 0), min(lo + t, size)))
        pad.append((max(-lo, 0), max(lo + t - size, 0)))
    out = volume[tuple(index)]
    return np.pad(out, pad, mode="constant", constant_values=out.min())


def rescale(volume: np.ndarray, out=(-1.0, 1.0), percentiles=(0.5, 99.5)) -> np.ndarray:
    """Clamp to the percentiles (linear interpolation between order
    statistics, in double) and map onto ``out``, in float32."""
    flat = np.sort(volume.reshape(-1))
    cut = []
    for p in percentiles:
        pos = (flat.size - 1) * (p / 100.0)
        lo, hi = int(np.floor(pos)), min(int(np.ceil(pos)), flat.size - 1)
        cut.append(float(flat[lo]) * (1 - (pos - lo)) + float(flat[hi]) * (pos - lo))
    v = np.clip(volume.astype(np.float32), cut[0], cut[1])
    v -= cut[0]
    v *= (out[1] - out[0]) / (cut[1] - cut[0])
    v += out[0]
    return v


def hippo_training_subject(volumes: dict, union: np.ndarray, target,
                           images=("mean_dwi", "md", "fa")):
    """X (3, *target) float32 and y (*target) uint8 class ids (1 inside
    either hippocampus) of one raw subject; ``union`` is the atlas mask
    that every subject is cropped around."""
    mask = union[0] > 0
    center = [(c.min() + c.max()) / 2 for c in np.where(mask)]
    X = np.concatenate([rescale(crop_or_pad(np.nan_to_num(volumes[k]), center, target))
                        for k in images]).astype(np.float32)
    y = crop_or_pad(volumes["whole_roi"], center, target)[0] > 0
    return X, y.astype(np.uint8)
