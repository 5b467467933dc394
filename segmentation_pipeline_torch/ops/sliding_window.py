"""Sliding-window inference on the device, ported from
segmentation_pipeline_tpu/ops/sliding_window.py.

Patches are sliced from the device-resident volume, the model runs on each
batch of them, and the predictions are added, weighted, into float32
accumulators patch by patch in location order (``average`` or ``hann``
overlap), then divided by the summed weights. Nothing goes to the host
between patches.

The JAX package pads the last batch to ``patch_batch`` with copies of the
last location at weight 0, because XLA needs one static shape; here the last
batch runs short. The sums are the same: each padded copy adds exactly 0.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .bitpack import argmax_ids


def grid_locations(spatial_shape: Sequence[int], patch_size: Sequence[int],
                   overlap: Sequence[int]) -> np.ndarray:
    """Patch start locations covering the volume: stride = patch - overlap,
    last window snapped to the boundary (torchio GridSampler coverage)."""
    starts = []
    for size, patch, ov in zip(spatial_shape, patch_size, overlap):
        if patch > size:
            raise ValueError(f"Patch size {patch} exceeds volume size {size}")
        stride = patch - ov
        if stride <= 0:
            raise ValueError(f"Overlap {ov} must be smaller than patch {patch}")
        axis_starts = list(range(0, size - patch + 1, stride))
        if axis_starts[-1] != size - patch:
            axis_starts.append(size - patch)
        starts.append(axis_starts)
    grid = np.stack(np.meshgrid(*starts, indexing="ij"), axis=-1).reshape(-1, 3)
    return grid.astype(np.int32)


def hann_window(patch_size: Sequence[int]) -> np.ndarray:
    """Separable raised-cosine weight window (smooth overlap blending)."""
    ws = []
    for p in patch_size:
        w = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(p) + 0.5) / p)
        ws.append(w.astype(np.float32))
    return ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]


def sliding_window_inference(volume: torch.Tensor,
                             model_fn: Callable[[torch.Tensor], torch.Tensor],
                             patch_size, patch_overlap=(0, 0, 0), patch_batch: int = 8,
                             mode: str = "average",
                             output_labels: bool = False) -> torch.Tensor:
    """volume: (C, W, H, D) on the device, in the dtype the model takes;
    model_fn maps channels-last patch batches (B, pw, ph, pd, C) to
    (B, pw, ph, pd, C_out), whose channel count the first batch gives.
    Returns the aggregated float32 prediction (C_out, W, H, D), or with
    ``output_labels`` its argmax over channels as (W, H, D) label ids of
    ``idx_dtype_for(C_out)``. ``mode``: 'average' (uniform overlap-add, the
    torchio default) or 'hann'."""
    if isinstance(patch_size, int):
        patch_size = (patch_size,) * 3
    if isinstance(patch_overlap, int):
        patch_overlap = (patch_overlap,) * 3
    if mode not in ("average", "hann"):
        raise ValueError(f"overlap mode must be 'average' or 'hann', not {mode!r}")
    pw, ph, pd = (int(p) for p in patch_size)
    with torch.inference_mode():
        # channels-last once, so that each patch is one slice
        volume = volume.permute(1, 2, 3, 0).contiguous()
        W, H, D, _ = volume.shape
        locations = grid_locations((W, H, D), (pw, ph, pd), patch_overlap).tolist()
        if mode == "hann":
            weight = torch.from_numpy(hann_window((pw, ph, pd))).to(volume.device)[..., None]
        else:
            weight = torch.ones((pw, ph, pd, 1), dtype=torch.float32, device=volume.device)
        acc = div = None
        for first in range(0, len(locations), patch_batch):
            batch = locations[first:first + patch_batch]
            patches = torch.stack([volume[w:w + pw, h:h + ph, d:d + pd] for w, h, d in batch])
            preds = model_fn(patches).float()
            if acc is None:
                acc = torch.zeros((W, H, D, preds.shape[-1]), dtype=torch.float32,
                                  device=volume.device)
                div = torch.zeros((W, H, D, 1), dtype=torch.float32, device=volume.device)
            for (w, h, d), pred in zip(batch, preds):
                acc[w:w + pw, h:h + ph, d:d + pd] += pred * weight
                div[w:w + pw, h:h + ph, d:d + pd] += weight
        out = acc / torch.clamp(div, min=1e-8)
        if output_labels:
            return argmax_ids(out, -1)
        return out.permute(3, 0, 1, 2)
