"""Device confusion reduction for validation sweeps, ported from
segmentation_pipeline_tpu/ops/confusion.py.

The host evaluator fetches the predicted ids volume and histograms it; this
module computes the same (L+1) x (L+1) joint histogram on the device, so a
sweep of SegmentationEvaluators fetches (L+1)^2 counts instead of an ids
volume. The bucket layout is the host's: row = target bucket, column =
prediction bucket, bucket L = any value not in ``label_values``. The probe
sweep of training/device_confusion.py holds the counts to the host chain's,
exactly, before any sweep relies on them.
"""
from __future__ import annotations

import numpy as np
import torch


def joint_histogram_device(target_idx: torch.Tensor, pred_idx: torch.Tensor,
                           n_buckets: int) -> torch.Tensor:
    """Joint histogram of two bucketed index volumes of one shape with values
    in [0, n_buckets): (n_buckets, n_buckets) int32, out[t, p] = the number
    of voxels with target t and prediction p. One integer bincount over the
    fused index, exact in any order."""
    flat = (target_idx.reshape(-1).long() * n_buckets + pred_idx.reshape(-1).long())
    counts = torch.bincount(flat, minlength=n_buckets * n_buckets)
    return counts.to(torch.int32).reshape(n_buckets, n_buckets)


def bucketed_joint_from_channel_ids(target_idx: torch.Tensor, pred_channel_ids: torch.Tensor,
                                    channel_maps: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """The joint histogram where the prediction side is raw argmax channel
    ids mapped into bucket space by ``channel_maps``: a (C,) LUT (a pure
    value remapping) or a full-shape (C, W, H, D) per-channel bucket tensor
    (label inversions that depend on the position, such as masked remaps)."""
    ids = pred_channel_ids.long()
    maps = channel_maps.long()
    if maps.dim() == 1:
        pred_idx = maps[ids]
    else:
        pred_idx = torch.gather(maps, 0, ids[None])[0]
    return joint_histogram_device(target_idx, pred_idx, n_buckets)


def value_lut(label_values: dict, vmax: int | None = None) -> np.ndarray:
    """LUT from raw label value to bucket index (bucket L = other), the one
    the host confusion statistics use."""
    values = [int(v) for v in label_values.values()]
    L = len(values)
    top = max(max(values, default=0), 0, int(vmax or 0))
    lut = np.full(top + 1, L, dtype=np.int32)
    for i, v in enumerate(values):
        if v >= 0:
            lut[v] = i
    return lut


def bucketize_values(ids: np.ndarray, lut: np.ndarray, n_buckets: int) -> np.ndarray:
    """Host side: a raw label-value volume in bucket space (values beyond
    the LUT -> bucket L), uint8 when it fits."""
    ids = np.asarray(ids)
    out = lut[np.clip(ids, 0, len(lut) - 1)]
    out = np.where((ids < 0) | (ids >= len(lut)), n_buckets - 1, out)
    return out.astype(np.uint8 if n_buckets <= 256 else np.int32)
