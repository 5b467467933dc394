"""Shifted-window multi-head self-attention over channels-last volumes, as
Swin UNETR computes it (MONAI ``monai/networks/nets/swin_unetr.py``, v1:
``get_window_size``, ``compute_mask``, ``window_partition``,
``window_reverse``, ``WindowAttention`` and
``SwinTransformerBlock.forward_part1``).

A stage of extent (W, H, D) runs windows of ``window`` tokens a side
(``window_geometry``: an axis no longer than the window takes its extent as
the window and shift 0). ``shifted_windows`` zero-pads the (normalized)
tokens to a multiple of the window, rolls them by minus the shift and
partitions them into (N * nW, n, C) windows; ``merge_windows`` undoes it.
The padded tokens are not masked, as published. A shifted block's windows
mask the pairs of tokens that come from different regions of the rolled
volume with -100 (``region_mask``); each head adds its learned relative
position bias, whose (2w - 1)^3 table is indexed by ``relative_index``,
taken ``[:n, :n]`` where the window was clipped to n tokens (as MONAI does;
for a clipped window that is not the clipped window's own index).

``window_attention`` is the attention itself, softmax(q k^T hd^-1/2 +
bias + mask) v of every window and head, and the one entry point a fused
kernel replaces. It runs ``F.scaled_dot_product_attention`` with the bias
(and mask) as an additive float mask, built once a call in the inputs'
dtype, in a buffer whose rows are padded to 16 elements so that the fused
kernels read it without a padded copy: an unshifted call's (heads, n, n)
bias broadcast over the batch of windows, a shifted call's (nW * heads, n,
n) bias + mask over the batch of volumes. On the H100 PyTorch runs it on
cuDNN's fused attention in bfloat16 (``cudnn_generated_fort_native_sdpa_*``
in the trace); the kernels accumulate the scores and the softmax in
float32. While the
profiler records, each call adds one to the ``window_attention`` counter of
utils/timer.py under (stage, N * windows, tokens, heads, head_dim,
shifted, dtype).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timer import count

Triple = Tuple[int, int, int]
# the attention mask's rows are allocated to a multiple of this many elements
MASK_ALIGNMENT = 16


def window_geometry(spatial: Sequence[int], window: int, shift: int) -> Tuple[Triple, Triple]:
    """MONAI's ``get_window_size``: per axis the window and the shift, the
    window clipped to an axis no longer than it and the shift there 0."""
    windows, shifts = [], []
    for size in spatial:
        if size <= window:
            windows.append(int(size))
            shifts.append(0)
        else:
            windows.append(window)
            shifts.append(shift)
    return tuple(windows), tuple(shifts)


def padded_extent(spatial: Sequence[int], window: Sequence[int]) -> Triple:
    """Each axis rounded up to a multiple of its window."""
    return tuple(-(-s // w) * w for s, w in zip(spatial, window))


@functools.lru_cache(maxsize=None)
def _relative_index(window: Triple) -> np.ndarray:
    w0, w1, w2 = window
    coords = np.stack(np.meshgrid(np.arange(w0), np.arange(w1), np.arange(w2), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel + np.array([w0 - 1, w1 - 1, w2 - 1])
    return rel[..., 0] * (2 * w1 - 1) * (2 * w2 - 1) + rel[..., 1] * (2 * w2 - 1) + rel[..., 2]


@functools.lru_cache(maxsize=None)
def relative_index(window: Triple, device: torch.device) -> torch.Tensor:
    """(n, n) int64 on ``device``: the relative position of token j to token
    i of an n = prod(window) token window, flattened into the
    (2w0 - 1)(2w1 - 1)(2w2 - 1) rows of the bias table."""
    return torch.from_numpy(_relative_index(tuple(window))).to(device)


def partition(x: torch.Tensor, window: Triple) -> torch.Tensor:
    """(N, W, H, D, C), each extent a multiple of its window -> (N * nW, n,
    C), the windows in (W, H, D) order, each window's tokens likewise."""
    n, W, H, D, c = x.shape
    w0, w1, w2 = window
    x = x.view(n, W // w0, w0, H // w1, w1, D // w2, w2, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, w0 * w1 * w2, c)


def unpartition(windows: torch.Tensor, window: Triple, shape: Sequence[int]) -> torch.Tensor:
    """The inverse of ``partition`` for a volume of ``shape`` (N, W, H, D)."""
    n, W, H, D = shape
    w0, w1, w2 = window
    x = windows.view(n, W // w0, H // w1, D // w2, w0, w1, w2, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(n, W, H, D, -1)


@functools.lru_cache(maxsize=None)
def _region_mask(padded: Triple, window: Triple, shift: Triple) -> np.ndarray:
    labels = np.zeros(padded, np.float32)
    region = 0
    cuts = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(window, shift)]
    for a in cuts[0]:
        for b in cuts[1]:
            for c in cuts[2]:
                labels[a, b, c] = region
                region += 1
    windows = partition(torch.from_numpy(labels)[None, ..., None], window)[..., 0].numpy()
    differ = windows[:, None, :] != windows[:, :, None]
    return np.where(differ, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def region_mask(padded: Triple, window: Triple, shift: Triple,
                device: torch.device) -> torch.Tensor:
    """MONAI's ``compute_mask``: (nW, n, n) float32 on ``device``, -100
    where the two tokens of a window come from different regions of the
    volume rolled by ``shift`` (each axis cut at -window and -shift), else
    0."""
    return torch.from_numpy(_region_mask(padded, window, shift)).to(device)


def shifted_windows(x: torch.Tensor, window: Triple, shift: Triple) -> torch.Tensor:
    """(N, W, H, D, C) tokens -> (N * nW, n, C) windows: zero-padded at the
    far end of each axis to a multiple of its window, rolled by minus the
    shift, partitioned."""
    _, W, H, D, _ = x.shape
    pads = [p - s for p, s in zip(padded_extent((W, H, D), window), (W, H, D))]
    if any(pads):
        x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    if any(shift):
        x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    return partition(x, window)


def merge_windows(windows: torch.Tensor, window: Triple, shift: Triple,
                  shape: Sequence[int]) -> torch.Tensor:
    """The inverse of ``shifted_windows`` for tokens of ``shape`` (N, W, H,
    D): unpartitioned, rolled back and unpadded."""
    n, W, H, D = shape
    x = unpartition(windows, window, (n, *padded_extent((W, H, D), window)))
    if any(shift):
        x = torch.roll(x, shifts=tuple(shift), dims=(1, 2, 3))
    return x[:, :W, :H, :D].contiguous()


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, stage: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + bias + mask) v of every window and head.

    q, k, v: (N * nW, heads, n, hd), the windows of each volume together;
    bias: (heads, n, n) in any float dtype; mask: (nW, n, n) of 0 and -100,
    or None for an unshifted block. Returns (N * nW, heads, n, hd) in q's
    dtype. ``stage`` only keys the counter."""
    bnw, heads, n, hd = q.shape
    dtype = q.dtype
    count("window_attention", (stage, bnw, n, heads, hd, mask is not None,
                               str(dtype).replace("torch.", "")))
    width = -(-n // MASK_ALIGNMENT) * MASK_ALIGNMENT
    if mask is None:
        rows = torch.empty((1, heads, n, width), dtype=dtype, device=q.device)
        rows[0, :, :, :n] = bias
        return F.scaled_dot_product_attention(q, k, v, attn_mask=rows[..., :n],
                                              scale=hd ** -0.5)
    nw = mask.shape[0]
    batch = bnw // nw
    rows = torch.empty((nw, heads, n, width), dtype=dtype, device=q.device)
    rows[..., :n] = bias[None] + mask[:, None]
    attn_mask = rows.view(1, nw * heads, n, width)[..., :n]

    def by_volume(t):
        return t.reshape(batch, nw * heads, n, hd)
    out = F.scaled_dot_product_attention(by_volume(q), by_volume(k), by_volume(v),
                                         attn_mask=attn_mask, scale=hd ** -0.5)
    # the fused kernels may return (N, nW * heads, n, hd) in another layout
    return out.reshape(bnw, heads, n, hd)
