"""Whole-volume sliding-window inference with the patch grid sharded over
the ranks of a mesh.

Ported from segmentation_pipeline_tpu/parallel/halo.py
(``distributed_sliding_window``). Patches are independent: the location
list is padded to a multiple of the ranks with copies of the last location
at validity 0, each rank takes its contiguous share, runs its patches in
batches of ``patch_batch`` (the last one short) and overlap-adds them,
weighted by validity, into a local accumulator and divisor, and one sum
all-reduce merges them. A padded location adds exactly nothing, so every
rank count gives the one-device sums up to their order. The shares do not
depend on ``patch_batch`` (the JAX package pads to a multiple of ranks x
patch batch, for its static shapes), so a rank that runs out of memory and
retries with a smaller batch still takes its own share.

The volume is replicated: each rank holds all of it. ``halo_exchange``,
``sharded_conv3d`` and ``sharded_volume_sliding_window`` (a W-sharded
volume) wait for ROADMAP Queue 1 item 10b.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.sliding_window import grid_locations, hann_window
from .mesh import Mesh, all_reduce_sum


def distributed_sliding_window(
    volume_cf: torch.Tensor,
    model_fn: Callable[..., torch.Tensor],
    patch_size,
    patch_overlap=(0, 0, 0),
    patch_batch: int = 1,
    mode: str = "average",
    mesh: Mesh = None,
    axis_name: str = "data",
    out_channels: int = None,
    model_args=(),
) -> torch.Tensor:
    """volume_cf: (C, W, H, D) on this rank's device in the dtype the model
    takes, the same on every rank; ``model_fn(patches, *model_args)`` maps
    channels-last patch batches (B, pw, ph, pd, C) to (B, pw, ph, pd,
    C_out). Returns the float32 prediction (C_out, W, H, D), the same on
    every rank.
    ``out_channels`` sizes the accumulator before the first batch (default:
    the first batch's channels)."""
    if mesh is None:
        raise ValueError("distributed_sliding_window needs a mesh")
    if axis_name != mesh.data_axis:
        raise ValueError(f"the patch grid shards over the mesh's data axis "
                         f"{mesh.data_axis!r}, not {axis_name!r}")
    if isinstance(patch_size, int):
        patch_size = (patch_size,) * 3
    if isinstance(patch_overlap, int):
        patch_overlap = (patch_overlap,) * 3
    if mode not in ("average", "hann"):
        raise ValueError(f"overlap mode must be 'average' or 'hann', not {mode!r}")
    pw, ph, pd = (int(p) for p in patch_size)
    patch_batch = max(1, int(patch_batch))
    with torch.inference_mode():
        # channels-last once, so that each patch is one slice
        volume = torch.as_tensor(volume_cf).permute(1, 2, 3, 0).contiguous()
        W, H, D, _ = volume.shape
        locations = grid_locations((W, H, D), (pw, ph, pd), patch_overlap)
        ranks = mesh.shape[axis_name]
        total = -(-len(locations) // ranks) * ranks
        n_real = len(locations)
        padded = np.concatenate([locations, np.repeat(locations[-1:], total - n_real, 0)])
        validity = np.ones(total, np.float32)
        validity[n_real:] = 0.0
        mine = mesh.rows(total)
        locs, valid = padded[mine].tolist(), validity[mine].tolist()

        if mode == "hann":
            weight = torch.from_numpy(hann_window((pw, ph, pd))).to(volume.device)[..., None]
        else:
            weight = torch.ones((pw, ph, pd, 1), dtype=torch.float32, device=volume.device)
        acc = None
        for first in range(0, len(locs), patch_batch):
            batch = locs[first:first + patch_batch]
            patches = torch.stack([volume[w:w + pw, h:h + ph, d:d + pd] for w, h, d in batch])
            preds = model_fn(patches, *model_args).float()
            if acc is None:
                channels = preds.shape[-1] if out_channels is None else int(out_channels)
                # the accumulator and divisor side by side: one all-reduce
                acc = torch.zeros((W, H, D, channels + 1), dtype=torch.float32,
                                  device=volume.device)
            for (w, h, d), pred, v in zip(batch, preds, valid[first:first + patch_batch]):
                w_v = weight * v
                region = acc[w:w + pw, h:h + ph, d:d + pd]
                region[..., :-1] += pred * w_v
                region[..., -1:] += w_v
        acc = all_reduce_sum(acc, mesh)
        out = acc[..., :-1] / torch.clamp(acc[..., -1:], min=1e-8)
        return out.permute(3, 0, 1, 2)
