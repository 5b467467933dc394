"""The operations and bytes of the port's window attention
(ops/window_attention.py::window_attention), from the keys of its
``window_attention`` counter: (stage, N * windows, tokens, heads, head_dim,
shifted, dtype).

FLOPs: q k^T and p v, 2 per multiply-add, 4 n^2 hd per window and head.
Bytes, each read or written once: Q, K and V in, O out, the relative
position bias of the window (heads x n x n) and, for a shifted block, the
region mask of one volume's windows (nW x n x n), in the call's dtype. The
bound is max(FLOPs over the dtype's dense peak, bytes over 3.35 TB/s), the
peaks of h100_bench/roofline.py.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

from .roofline import ITEM_BYTES, PEAK_BYTES, PEAK_FLOPS

Key = Tuple[int, int, int, int, int, bool, str]


def windows_per_volume(patch: Sequence[int], patch_size: int, window: int, stage: int) -> int:
    """nW of a stage: its extent (the window's patch over patch_size *
    2^stage) in windows, each axis padded to a multiple of its window (an
    axis no longer than the window is one window)."""
    extent = [p // (patch_size * 2 ** stage) for p in patch]
    return math.prod(-(-e // min(window, e)) for e in extent)


def attention_flops(key: Key) -> float:
    _, bnw, n, heads, hd, _, _ = key
    return 4.0 * bnw * n * n * hd * heads


def attention_bytes(key: Key, nw: int) -> float:
    _, bnw, n, heads, hd, shifted, dtype = key
    elements = 4 * bnw * heads * n * hd + heads * n * n + (nw * n * n if shifted else 0)
    return float(elements * ITEM_BYTES["torch." + dtype])


def attention_bound_s(key: Key, nw: int) -> float:
    dtype = "torch." + key[6]
    return max(attention_flops(key) / PEAK_FLOPS[dtype], attention_bytes(key, nw) / PEAK_BYTES)
