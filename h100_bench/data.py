"""What the benchmark feeds both sides, made from ``--seed``: network
weights (on the card, in two draws), dmri_hippo and msseg2 volumes, and the
dmri_hippo training set on disk.

The volume makers follow the repository's chip check script
(``hippo_volumes``, ``write_hippo_dataset``, ``msseg2_volumes``), frozen
here so that a change to the program cannot move the yardstick. The NIfTI
writer is the benchmark's own: nothing of the program makes an input.
"""
from __future__ import annotations

import gzip
import json
import os
import struct
from typing import Dict, Sequence

import numpy as np
import torch

HIPPO_IMAGES = ("mean_dwi", "md", "fa")
# the voxel spacing (mm) of hippo_volumes' affine
HIPPO_SPACING = (1.2, 1.2, 1.5)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _leaf_law(name: str, shape) -> tuple:
    """(law, a, b) of one state-dict entry: conv kernels and biases
    U(-1/sqrt(fan_in), +) (torch's conv init), BatchNorm scales U(0.8, 1.2)
    and shifts N(0, 0.1), running means N(0, 0.05) and variances
    U(0.05, 0.2), so that eval-mode BatchNorm is not the identity."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return "uniform", 0.05, 0.2
    if leaf == "running_mean":
        return "normal", 0.0, 0.05
    if len(shape) == 5:
        bound = 1.0 / float(np.sqrt(np.prod(shape[1:])))
        return "uniform", -bound, bound
    if leaf == "weight":
        return "uniform", 0.8, 1.2
    return "bias", 0.0, 0.1


def make_weights(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """Random float32 weights for every entry of ``template`` (a state dict's
    names and shapes) from ``seed``, on ``device``: one uniform and one
    normal draw from a ``torch.Generator`` there, cut into the entries in
    name order. Conv biases are drawn as a conv kernel's would be, from the
    fan-in of the kernel beside them."""
    names = sorted(k for k, v in template.items() if v.is_floating_point())
    laws = {}
    for name in names:
        shape = tuple(template[name].shape)
        law = _leaf_law(name, shape)
        if law[0] == "bias":
            kernel = template.get(name[:-len("bias")] + "weight")
            if kernel is not None and kernel.dim() == 5:
                bound = 1.0 / float(np.sqrt(np.prod(kernel.shape[1:])))
                law = ("uniform", -bound, bound)
            else:
                law = ("normal", 0.0, 0.1)
        laws[name] = law
    sizes = {"uniform": 0, "normal": 0}
    for name in names:
        sizes[laws[name][0]] += template[name].numel()
    g = torch.Generator(device=device).manual_seed(int(seed))
    pools = {"uniform": torch.rand(sizes["uniform"], generator=g, device=device),
             "normal": torch.randn(sizes["normal"], generator=g, device=device)}
    used = {"uniform": 0, "normal": 0}
    out = {}
    for name in names:
        law, a, b = laws[name]
        n = template[name].numel()
        v = pools[law][used[law]:used[law] + n]
        used[law] += n
        v = a + (b - a) * v if law == "uniform" else a + b * v
        out[name] = v.reshape(template[name].shape).contiguous()
    for name, value in template.items():
        if name not in out:  # integer buffers (BatchNorm's batch count)
            out[name] = torch.zeros_like(value, device=device)
    return out


# ---------------------------------------------------------------------------
# dmri_hippo
# ---------------------------------------------------------------------------

def hippo_volumes(rng: np.random.Generator, grid):
    """One raw dmri_hippo subject on the scanner grid ``grid`` (W, H, D):
    the three modalities with a few NaN voxels, the whole-hippocampus label
    map (1 left, 2 right) and the atlas union mask, and an affine whose
    first axis is negative (world x falls as W grows, so the right
    hemisphere is the lower half of W)."""
    W, H, D = grid
    out = {}
    for name in HIPPO_IMAGES:
        vol = rng.gamma(2.0, 1.0, (1, W, H, D)).astype(np.float32)
        vol.reshape(-1)[rng.choice(vol.size, 5, replace=False)] = np.nan
        out[name] = vol
    roi = np.zeros((1, W, H, D), np.int32)
    hw, hh, dd = max(W // 8, 1), max(H // 6, 1), max(D // 4, 1)
    h0, d0 = H // 2 + int(rng.integers(-1, 2)), D // 2
    roi[0, W // 2 - 3 * hw:W // 2 - hw, h0 - hh:h0 + hh, d0 - dd:d0 + dd] = 2  # right
    roi[0, W // 2 + hw:W // 2 + 3 * hw, h0 - hh:h0 + hh, d0 - dd:d0 + dd] = 1  # left
    union = np.zeros_like(roi)
    union[0, W // 2 - 3 * hw - 1:W // 2 + 3 * hw + 1, h0 - hh - 1:h0 + hh + 1,
          d0 - dd - 1:d0 + dd + 1] = 1
    out["whole_roi"], out["whole_roi_union"] = roi, union
    affine = np.diag([-HIPPO_SPACING[0], HIPPO_SPACING[1], HIPPO_SPACING[2], 1.0])
    affine[:3, 3] = [0.6 * W, -0.6 * H, -0.75 * D]
    return out, affine


def rescale_percentiles(volume: np.ndarray, lo_pct=0.5, hi_pct=99.5, out=(-1.0, 1.0)):
    """Clamp to the percentiles and map linearly onto ``out`` (float32)."""
    lo, hi = np.percentile(volume, [lo_pct, hi_pct])
    v = np.clip(volume, lo, hi).astype(np.float32)
    return ((v - lo) * ((out[1] - out[0]) / max(hi - lo, 1e-12)) + out[0]).astype(np.float32)


def hippo_input(rng: np.random.Generator, crop) -> np.ndarray:
    """A dmri_hippo request's model input (3, W, H, D) at the crop: the three
    modalities of ``hippo_volumes``, NaN to 0, each rescaled to [-1, 1]
    between its 0.5th and 99.5th percentiles, as the default pipeline
    leaves them."""
    volumes, _ = hippo_volumes(rng, crop)
    return np.concatenate([rescale_percentiles(np.nan_to_num(volumes[k]))
                           for k in HIPPO_IMAGES])


def _write_nifti(path: str, data: np.ndarray, affine: np.ndarray) -> None:
    """A single-volume (1, W, H, D) NIfTI-1 file with an sform affine,
    gzip-compressed."""
    arr = np.asarray(data)[0]
    codes = {np.dtype(np.float32): 16, np.dtype(np.int32): 8}
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *arr.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, codes[arr.dtype])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    spacing = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)
    struct.pack_into("<h", hdr, 254, 1)
    for row in range(3):
        struct.pack_into("<4f", hdr, 280 + 16 * row, *affine[row])
    hdr[344:348] = b"n+1\x00"
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(bytes(hdr) + b"\x00" * 4 + arr.tobytes(order="F"))


def write_hippo_dataset(root: str, seed: int, grid, counts: Dict[str, int]) -> None:
    """dmri_hippo's layout under ``root``: subjects/<name>/{mean_dwi, md, fa,
    whole_roi}.nii.gz and attributes.json (protocol, age; fold for cbbrain),
    atlas/whole_roi_union.nii.gz, and attributes/{cross_validation_split,
    ab300_validation_subjects, cbbrain_test_subjects}.json: ``counts``
    cbbrain subjects in fold 0 ("validation") and in folds 1-4
    ("training"), and "ab300" subjects with ages, on the scanner grid
    ``grid``."""
    rng = np.random.default_rng(seed)
    n_cbbrain = counts["validation"] + counts["training"]
    split, ab300 = {}, {}
    for i in range(n_cbbrain + counts["ab300"]):
        cbbrain = i < n_cbbrain
        name = f"cbbrain_{i:03d}" if cbbrain else f"ab300_{i:03d}"
        folder = os.path.join(root, "subjects", name)
        os.makedirs(folder)
        volumes, affine = hippo_volumes(rng, grid)
        for key in (*HIPPO_IMAGES, "whole_roi"):
            _write_nifti(os.path.join(folder, f"{key}.nii.gz"), volumes[key], affine)
        if i == 0:
            os.makedirs(os.path.join(root, "atlas"))
            _write_nifti(os.path.join(root, "atlas", "whole_roi_union.nii.gz"),
                         volumes["whole_roi_union"], affine)
        attributes = {"protocol": "cbbrain" if cbbrain else "ab300", "age": 20.0 + 2.5 * i}
        if cbbrain:
            attributes["fold"] = 0 if i < counts["validation"] else 1 + i % 4
            split[name] = {"fold": attributes["fold"]}
        else:
            ab300[name] = {"ab300_validation": True}
        with open(os.path.join(folder, "attributes.json"), "w") as f:
            json.dump(attributes, f)
    os.makedirs(os.path.join(root, "attributes"))
    for file_name, data in (("cross_validation_split", split),
                            ("ab300_validation_subjects", ab300),
                            ("cbbrain_test_subjects", {})):
        with open(os.path.join(root, "attributes", f"{file_name}.json"), "w") as f:
            json.dump(data, f)


def hippo_training_volumes(seed: int, grid, counts: Dict[str, int]):
    """The raw volumes of the training subjects that ``write_hippo_dataset``
    writes for ``seed`` (cbbrain, folds 1-4), made again in memory, and the
    atlas union mask it writes (the first subject's)."""
    rng = np.random.default_rng(seed)
    first = counts["validation"]
    made = [hippo_volumes(rng, grid)[0] for _ in range(first + counts["training"])]
    return made[first:], made[0]["whole_roi_union"]


# ---------------------------------------------------------------------------
# msseg2
# ---------------------------------------------------------------------------

def msseg2_input(rng: np.random.Generator, grid: Sequence[int],
                 semi_axes: Sequence[float]) -> np.ndarray:
    """An msseg2 request's model input (2, W, H, D) on the model grid (1 mm):
    two FLAIR time points (an ellipsoid brain of ``semi_axes`` voxels
    brighter than the background, noise, a few bright lesions, more in the
    second), each rescaled to [-1, 1] between its 0.5th and 99.5th
    percentiles."""
    centre = [(n - 1) / 2 for n in grid]
    axes = np.ogrid[tuple(slice(0, n) for n in grid)]
    r2 = sum(((a - c) / r) ** 2 for a, c, r in zip(axes, centre, semi_axes))
    brain = r2 <= 1.0
    inside = np.argwhere(brain)
    out = []
    for t in range(2):
        flair = np.where(brain, 1.0, 0.1).astype(np.float32)
        flair += rng.normal(0, 0.05, tuple(grid)).astype(np.float32)
        for w, h, d in inside[rng.choice(len(inside), 4 + 2 * t, replace=False)]:
            flair[max(w - 2, 0):w + 3, max(h - 2, 0):h + 3, max(d - 1, 0):d + 2] += 0.8
        out.append(rescale_percentiles(flair[None]))
    return np.concatenate(out)
