"""Device-side volume resampling (affine grid, trilinear or nearest).

Ported from segmentation_pipeline_tpu/ops/resample.py: destination voxel ->
source voxel coordinates from the two affines, sampled with
``ops/augment.py``'s flat-index gather, a constant outside the source grid
(zero: scipy's mode='constant', as the host transforms resample).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from .augment import _identity_coords, trilinear_sample


def resample_volume(data_cf, src_affine: np.ndarray, dst_affine: np.ndarray,
                    dst_shape: Tuple[int, int, int], order: int = 1,
                    device=None) -> torch.Tensor:
    """Resample (C, W, H, D) data from the src grid onto the dst grid in
    world space, on ``device`` (the card unless it says otherwise). order:
    0 nearest (labels) or 1 trilinear. Returns (C, W', H', D') float32."""
    M = np.linalg.inv(np.asarray(src_affine)) @ np.asarray(dst_affine)
    volume = torch.as_tensor(data_cf).to(resolve_device(device), torch.float32)
    matrix = torch.as_tensor(M[:3, :3], dtype=torch.float32, device=volume.device)
    offset = torch.as_tensor(M[:3, 3], dtype=torch.float32, device=volume.device)
    dst_idx = _identity_coords(tuple(int(s) for s in dst_shape), volume.device)
    src_idx = torch.einsum("ij,jwhd->iwhd", matrix, dst_idx) + offset.view(3, 1, 1, 1)
    volume_cl = torch.movedim(volume, 0, -1)
    out = trilinear_sample(volume_cl, src_idx, nearest=order == 0)
    src_shape = torch.tensor(volume_cl.shape[:3], dtype=torch.float32,
                             device=volume.device).view(3, 1, 1, 1)
    inside = ((src_idx >= -0.5) & (src_idx <= src_shape - 0.5)).all(dim=0)
    return torch.movedim(torch.where(inside[..., None], out, 0.0), -1, 0)
