"""The msseg2 training set of the ``msseg2-train-f32`` cell, made from
``--seed`` and written in the layout msseg2's ``build_ingestion()`` reads:
one folder per subject holding ``flair_time01``, ``flair_time02``,
``brain_mask`` and ``ground_truth`` as NIfTI files on the 1 mm grid. The
volumes follow ``data.msseg2_input``'s law (an ellipsoid brain brighter
than the background, noise, bright lesions, more at the second time
point), left raw (the configuration's host pipeline rescales them); the
ground truth is the second time point's lesions.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .data import _write_nifti

TIMEPOINTS = ("flair_time01", "flair_time02")


def msseg2_volumes(rng: np.random.Generator, grid: Sequence[int], semi_axes: Sequence[float]):
    """One raw subject on the 1 mm grid ``grid``: both FLAIRs (1, W, H, D)
    float32, the brain mask and the ground truth (1, W, H, D) int32."""
    centre = [(n - 1) / 2 for n in grid]
    axes = np.ogrid[tuple(slice(0, n) for n in grid)]
    r2 = sum(((a - c) / r) ** 2 for a, c, r in zip(axes, centre, semi_axes))
    brain = r2 <= 1.0
    inside = np.argwhere(brain)
    out = {"brain_mask": brain[None].astype(np.int32)}
    lesions = np.zeros(tuple(grid), np.int32)
    for t, name in enumerate(TIMEPOINTS):
        flair = np.where(brain, 1.0, 0.1).astype(np.float32)
        flair += rng.normal(0, 0.05, tuple(grid)).astype(np.float32)
        for w, h, d in inside[rng.choice(len(inside), 4 + 2 * t, replace=False)]:
            box = (slice(max(w - 2, 0), w + 3), slice(max(h - 2, 0), h + 3),
                   slice(max(d - 1, 0), d + 2))
            flair[box] += 0.8
            if t == 1:
                lesions[box] = 1
        out[name] = flair[None]
    out["ground_truth"] = (lesions * brain)[None]
    return out


def write_msseg2_dataset(root: str, seed: int, grid: Sequence[int], semi_axes: Sequence[float],
                         subjects: int) -> None:
    """``subjects`` raw subjects under ``root`` (folders ``ms-00`` ...), on the
    1 mm grid with the first axis negative, as the scanner's are."""
    rng = np.random.default_rng(seed)
    affine = np.diag([-1.0, 1.0, 1.0, 1.0])
    affine[:3, 3] = [grid[0] / 2, -grid[1] / 2, -grid[2] / 2]
    for i in range(subjects):
        folder = os.path.join(root, f"ms-{i:02d}")
        os.makedirs(folder)
        volumes = msseg2_volumes(rng, grid, semi_axes)
        for name in (*TIMEPOINTS, "brain_mask", "ground_truth"):
            _write_nifti(os.path.join(folder, f"{name}.nii.gz"), volumes[name], affine)


def brain_box(grid: Sequence[int], semi_axes: Sequence[float]):
    """The extent of ``msseg2_volumes``' brain mask along each axis (its
    bounding box, to which the pipeline crops)."""
    return tuple(int(np.sum(np.abs(np.arange(n) - (n - 1) / 2) <= r))
                 for n, r in zip(grid, semi_axes))
