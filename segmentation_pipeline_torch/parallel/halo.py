"""Spatial sharding over ``torch.distributed``: halo exchange and the
sliding window, with the patch grid or the volume itself sharded over the
ranks of a mesh.

Ported from segmentation_pipeline_tpu/parallel/halo.py.

- ``halo_exchange`` widens this rank's slab of a W-sharded tensor by
  ``halo`` rows of each neighbour's, zeros at the global ends; autograd
  sends each halo's cotangent back to its owner, which adds it into its
  edge rows (JAX differentiates its ``ppermute``; here the backward is
  written out). gloo's ``send``/``recv`` take CPU tensors only, and the
  gloo ranks that share one card hold CUDA tensors, so the exchange is an
  ``all_gather`` of every rank's first and last ``halo`` rows over the
  axis's group, of which each rank keeps its neighbours': one collective
  that gloo and NCCL both carry, on CPU and CUDA tensors alike. At two
  ranks it moves what a pair of point-to-point swaps would.
- ``halo_conv3d`` (and ``sharded_conv3d``, its one-volume form): the
  3x3x3/s1/p1 conv of a W-sharded batch: the halo exchange of one row,
  the hand kernel (``ops/conv3x3.py`` through ``ops/convolution.conv3d``)
  on the widened slab with padding 1, and the W rows [1, w + 1) of its
  output, which are the unsharded conv's.
- ``distributed_sliding_window``: the volume replicated, the patch grid
  sharded. The location list is padded to a multiple of the ranks with
  copies of the last location at validity 0, each rank takes its
  contiguous share, runs its patches in batches of ``patch_batch`` (the
  last one short) and overlap-adds them, weighted by validity, into a
  local accumulator and divisor, and one sum all-reduce over the axis
  merges them. A padded location adds exactly nothing, so every rank
  count gives the one-device sums up to their order. The shares do not
  depend on ``patch_batch`` (the JAX package pads to a multiple of ranks x
  patch batch, for its static shapes), so a rank that runs out of memory
  and retries with a smaller batch still takes its own share.
- ``sharded_volume_sliding_window``: the volume itself W-sharded, never
  whole on one device. Each rank reads its patches through a halo of one
  patch width, owns the patches whose start row it holds, overlap-adds
  them into an accumulator with a write margin of one patch width, and
  adds the right margin of its left neighbour into its head rows.

A W-sharded tensor is, on each rank, its slab (``Mesh.w_slab``):
functions here take and return slabs; ``parallel.mesh.gather_w`` joins
them. ``TRAFFIC`` counts this rank's halo exchanges (``calls``) and the
bytes it contributes to them (``bytes``), forward and backward.
"""
from __future__ import annotations

import collections
from typing import Callable

import numpy as np
import torch

from ..ops.sliding_window import grid_locations, hann_window
from .mesh import Mesh, all_reduce_sum, gather_along

TRAFFIC = collections.Counter()


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, mesh, axis_name, dim):
        ctx.halo, ctx.mesh, ctx.axis_name, ctx.dim = halo, mesh, axis_name, dim
        xm = x.movedim(dim, 0)
        edges = torch.cat([xm[:halo], xm[-halo:]])
        left, right = _neighbours(edges, halo, mesh, axis_name)
        # the left neighbour's last rows, then the right neighbour's first
        left = torch.zeros_like(xm[:halo]) if left is None else left[halo:]
        right = torch.zeros_like(xm[:halo]) if right is None else right[:halo]
        return torch.cat([left, xm, right]).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        halo = ctx.halo
        gm = g.movedim(ctx.dim, 0)
        # the cotangents of the rows that came from the left neighbour (its
        # last rows) and from the right one (its first rows)
        edges = torch.cat([gm[:halo], gm[-halo:]])
        left, right = _neighbours(edges, halo, ctx.mesh, ctx.axis_name)
        dx = gm[halo:-halo].clone()
        if left is not None:  # my first rows were the left neighbour's right halo
            dx[:halo] += left[halo:]
        if right is not None:  # my last rows were the right neighbour's left halo
            dx[-halo:] += right[:halo]
        return dx.movedim(0, ctx.dim), None, None, None, None


def _neighbours(edges, halo, mesh, axis_name):
    """All-gathers every rank's ``edges`` (its first and last ``halo``
    rows, stacked) along the axis; returns the left and the right
    neighbour's (None at a global end)."""
    ranks, me = mesh.shape[axis_name], mesh.coords[axis_name]
    if ranks == 1:
        return None, None
    TRAFFIC["calls"] += 1
    TRAFFIC["bytes"] += edges.numel() * edges.element_size()
    parts = gather_along(edges, mesh, axis_name)
    return (parts[me - 1] if me > 0 else None), (parts[me + 1] if me < ranks - 1 else None)


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh, axis_name: str,
                  axis: int = 0) -> torch.Tensor:
    """This rank's slab ``x`` of a tensor whose dimension ``axis`` is
    sharded over the mesh's ``axis_name``, widened by ``halo`` rows of each
    neighbour's slab on that dimension (zeros at the global ends).
    Differentiable; every rank of the axis's line must call it."""
    halo = int(halo)
    if halo < 1 or x.shape[axis] < halo:
        raise ValueError(f"a halo of {halo} rows from a slab of {x.shape[axis]}: the halo "
                         "must be at least 1 and at most the slab")
    return _HaloExchange.apply(x, halo, mesh, axis_name, axis)


def halo_conv3d(x: torch.Tensor, kernel: torch.Tensor, mesh: Mesh,
                axis_name: str) -> torch.Tensor:
    """The 3^3/s1/p1 conv of a batch whose W axis is sharded over the
    mesh's ``axis_name``: the halo exchange of one row, the hand kernel
    with padding 1 on the widened slab, its W rows [1, w + 1). x: this
    rank's slab (N, w, H, D, Cin); kernel (3, 3, 3, Cin, Cout); returns the
    slab (N, w, H, D, Cout) of the unsharded conv."""
    from ..ops.convolution import conv3d

    x_ext = halo_exchange(x, 1, mesh, axis_name, axis=1)
    return conv3d(x_ext, kernel, stride=1, padding=1)[:, 1:-1]


def sharded_conv3d(x: torch.Tensor, kernel: torch.Tensor, mesh: Mesh,
                   axis_name: str = "data") -> torch.Tensor:
    """``halo_conv3d`` of one volume: x is this rank's slab (w, H, D, Cin);
    returns the slab (w, H, D, Cout) of the unsharded conv."""
    return halo_conv3d(x[None], kernel, mesh, axis_name)[0]


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
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis_name!r}")
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
        mine = mesh.rows(total, axis_name)
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
        acc = all_reduce_sum(acc, mesh, (axis_name,))
        out = acc[..., :-1] / torch.clamp(acc[..., -1:], min=1e-8)
        return out.permute(3, 0, 1, 2)


def sharded_volume_sliding_window(
    volume_cf: torch.Tensor,
    model_fn: Callable[..., torch.Tensor],
    patch_size,
    patch_overlap=(0, 0, 0),
    mode: str = "average",
    mesh: Mesh = None,
    axis_name: str = "data",
    out_channels: int = None,
    model_args=(),
    patch_batch: int = 1,
) -> torch.Tensor:
    """Sliding-window inference on a volume whose W axis is sharded over
    the mesh's ``axis_name``: no rank holds the whole volume.

    volume_cf: this rank's slab (C, w, H, D) of a volume of W = w x ranks
    (``Mesh.w_slab``), on its device in the dtype the model takes;
    ``model_fn(patches, *model_args)`` maps channels-last patch batches
    (B, pw, ph, pd, C) to (B, pw, ph, pd, C_out). Returns this rank's slab
    (C_out, w, H, D) of the float32 prediction, equal to the unsharded
    window's up to the order of its sums.

    The slab is read through a halo of one patch width on each side; each
    patch belongs to the rank that holds its start row and overlap-adds
    into an accumulator that spans the halo too. Patches start at most one
    slab to the left of a slab's end, so only the right margin takes
    writes: it is added into the right neighbour's head rows. Runs the
    owned patches in batches of ``patch_batch``. Needs w >= the patch
    width."""
    if mesh is None:
        raise ValueError("sharded_volume_sliding_window needs a mesh")
    if isinstance(patch_size, int):
        patch_size = (patch_size,) * 3
    if isinstance(patch_overlap, int):
        patch_overlap = (patch_overlap,) * 3
    if mode not in ("average", "hann"):
        raise ValueError(f"overlap mode must be 'average' or 'hann', not {mode!r}")
    pw, ph, pd = (int(p) for p in patch_size)
    patch_batch = max(1, int(patch_batch))
    ranks, me = mesh.shape[axis_name], mesh.coords[axis_name]
    with torch.inference_mode():
        volume = torch.as_tensor(volume_cf).permute(1, 2, 3, 0).contiguous()
        w_loc, H, D, _ = volume.shape
        W = w_loc * ranks
        if w_loc < pw:
            raise ValueError(f"local W {w_loc} must be >= patch width {pw}")
        locations = grid_locations((W, H, D), (pw, ph, pd), patch_overlap)
        # W relative to the halo-widened slab
        mine = [(int(w) - me * w_loc + pw, int(h), int(d)) for w, h, d in locations
                if min(int(w) // w_loc, ranks - 1) == me]
        ext = halo_exchange(volume, pw, mesh, axis_name, axis=0)
        if mode == "hann":
            weight = torch.from_numpy(hann_window((pw, ph, pd))).to(volume.device)[..., None]
        else:
            weight = torch.ones((pw, ph, pd, 1), dtype=torch.float32, device=volume.device)
        acc = None
        for first in range(0, len(mine), patch_batch):
            batch = mine[first:first + patch_batch]
            patches = torch.stack([ext[w:w + pw, h:h + ph, d:d + pd] for w, h, d in batch])
            preds = model_fn(patches, *model_args).float()
            if acc is None:
                channels = preds.shape[-1] if out_channels is None else int(out_channels)
                # the accumulator and divisor side by side: one exchange
                acc = torch.zeros((w_loc + 2 * pw, H, D, channels + 1), dtype=torch.float32,
                                  device=volume.device)
            for (w, h, d), pred in zip(batch, preds):
                region = acc[w:w + pw, h:h + ph, d:d + pd]
                region[..., :-1] += pred * weight
                region[..., -1:] += weight
        # the right margin's writes belong to the right neighbour's head rows
        margins = gather_along(acc[-pw:], mesh, axis_name)
        if me > 0:
            acc[pw:2 * pw] += margins[me - 1]
        interior = acc[pw:w_loc + pw]
        out = interior[..., :-1] / torch.clamp(interior[..., -1:], min=1e-8)
        return out.permute(3, 0, 1, 2)
