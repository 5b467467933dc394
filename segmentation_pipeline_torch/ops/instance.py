"""Device instance-overlap reduction for validation sweeps, ported from
segmentation_pipeline_tpu/ops/instance.py.

The host instance evaluator labels the connected components of both masks
and histograms their overlap; the detection test needs only that
(N+1, M+1) histogram. Here it is computed on the device:

1. ``connected_components_device`` labels each mask (ops/morphology.py);
2. the labels are compacted to a fixed capacity K: background to bucket 0
   and the components to buckets 1..N in ascending smallest-flat-index
   order, the host labeller's first-occurrence order, so the histogram
   matches the host's entry for entry;
3. ``joint_histogram_device`` (ops/confusion.py) counts the pairs.

A sweep then fetches (K+1)^2 counts and 2(K+1) label ids per subject. More
than K components in a mask is an overflow, seen on the host from the
fetched ids (``component_count``); the caller then takes the host path.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .confusion import joint_histogram_device
from .morphology import connected_components_device

#: above every component label (flat voxel index + 1 < 2^30)
_FILL = 2 ** 30


def compact_labels_device(labels: torch.Tensor, capacity: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx, uniq): ``uniq`` the sorted (capacity + 1,) unique labels (0
    first, the component ids ascending, padded with _FILL; with more
    components, the capacity + 1 smallest, as jnp.unique(size=...) keeps);
    ``idx`` each voxel's position in ``uniq``, clipped to capacity."""
    flat = labels.reshape(-1).to(torch.int32)
    # 0 always takes bucket 0, even in an all-foreground mask
    with_bg = torch.cat([flat.new_zeros(1), flat])
    uniq = torch.unique(with_bg, sorted=True)
    k = capacity + 1
    if uniq.numel() >= k:
        uniq = uniq[:k]
    else:
        uniq = torch.cat([uniq, uniq.new_full((k - uniq.numel(),), _FILL)])
    idx = torch.searchsorted(uniq, flat).clamp(max=capacity).to(torch.int32)
    return idx.reshape(labels.shape), uniq


def component_count(uniq) -> Tuple[int, bool]:
    """(number of components, overflowed?) from a fetched ``uniq``: an
    overflow fills the capacity, and then there may be more components."""
    uniq = np.asarray(uniq)
    n_finite = int((uniq < _FILL).sum())
    return n_finite - 1, n_finite == len(uniq)


def overlap_histogram_device(target_mask: torch.Tensor, pred_mask: torch.Tensor,
                             capacity: int = 255, connectivity: int = 2):
    """The instance evaluator's overlap histogram with its labelling, on the
    device. Masks: (W, H, D) boolean. Returns (hist, t_uniq, p_uniq): hist
    (capacity+1, capacity+1) int32, hist[i, j] = |target component i ∩
    predicted component j| (0 = background), zero beyond the component
    counts; the uniq vectors for ``component_count``."""
    t_idx, t_uniq = compact_labels_device(
        connected_components_device(target_mask, connectivity=connectivity), capacity)
    p_idx, p_uniq = compact_labels_device(
        connected_components_device(pred_mask, connectivity=connectivity), capacity)
    return joint_histogram_device(t_idx, p_idx, capacity + 1), t_uniq, p_uniq


def instance_hist_from_channel_ids(target_fg: torch.Tensor, pred_channel_ids: torch.Tensor,
                                   fg_maps: torch.Tensor, capacity: int = 255,
                                   connectivity: int = 2):
    """``overlap_histogram_device`` where the prediction side is raw argmax
    channel ids mapped to eval-space foreground by per-channel maps:
    fg_maps[c, w, h, d] says whether an argmax of c there inverts to a
    positive eval label (training/device_confusion.py builds them)."""
    pred_fg = torch.gather(fg_maps.bool(), 0, pred_channel_ids.long()[None])[0]
    return overlap_histogram_device(target_fg, pred_fg, capacity, connectivity)
