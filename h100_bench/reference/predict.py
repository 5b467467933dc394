"""The predictors' arithmetic in plain PyTorch on (N, C, W, H, D): the
sagittal split (each volume's two halves of W as two samples, the second
mirrored), flip test-time augmentation with majority votes, and the
sliding window's tiling (stride patch - overlap, the last window snapped
to the boundary) with uniform averaging of the overlaps."""
from __future__ import annotations

import itertools
from typing import Callable, Sequence

import torch


def split_and_flip(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[2] // 2
    return torch.cat([x[:, :, :half], torch.flip(x[:, :, half:], dims=(2,))], dim=0)


def merge_halves(y: torch.Tensor) -> torch.Tensor:
    n = y.shape[0] // 2
    return torch.cat([y[:n], torch.flip(y[n:], dims=(2,))], dim=2)


def flip_sets(dims: Sequence[int]):
    """Every combination of ``dims``, the empty one first."""
    return [c for r in range(len(dims) + 1) for c in itertools.combinations(dims, r)]


def majority(labels: Sequence[torch.Tensor], n_classes: int) -> torch.Tensor:
    """The class most members voted for at each voxel; a tie goes to the
    smallest class. labels: member label maps of one shape."""
    counts = torch.stack([sum((m == c).to(torch.int32) for m in labels)
                          for c in range(n_classes)])
    return counts.argmax(0)


def flip_tta(fn: Callable, x: torch.Tensor, dims: Sequence[int], n_classes: int):
    """Majority over the flips of ``dims`` of the labels of ``fn`` (which
    maps (N, C, ...) to softmax probabilities), each member flipped back;
    and at each voxel the smallest margin of any member's call: its best
    class's logit less its second best's (the log of their probabilities'
    ratio)."""
    members, margin = [], None
    for flips in flip_sets(dims):
        y = fn(torch.flip(x, dims=flips) if flips else x)
        y = torch.flip(y, dims=flips) if flips else y
        members.append(y.argmax(1))
        top = y.topk(2, dim=1).values.clamp_min(1e-30).log()
        m = top[:, 0] - top[:, 1]
        margin = m if margin is None else torch.minimum(margin, m)
    return majority(members, n_classes), margin


def window_starts(size: int, patch: int, overlap: int):
    starts = list(range(0, size - patch + 1, patch - overlap))
    if starts[-1] != size - patch:
        starts.append(size - patch)
    return starts


def sliding_window_average(volume: torch.Tensor, fn: Callable, patch: int,
                           overlap: int) -> torch.Tensor:
    """volume (C, W, H, D) -> the average over the windows covering each
    voxel of ``fn`` on one (1, C, p, p, p) window at a time, (C_out, W, H, D)."""
    spatial = volume.shape[1:]
    acc = count = None
    for w, h, d in itertools.product(*(window_starts(s, patch, overlap) for s in spatial)):
        y = fn(volume[None, :, w:w + patch, h:h + patch, d:d + patch])[0].float()
        if acc is None:
            acc = torch.zeros((y.shape[0], *spatial), device=y.device)
            count = torch.zeros((1, *spatial), device=y.device)
        acc[:, w:w + patch, h:h + patch, d:d + patch] += y
        count[:, w:w + patch, h:h + patch, d:d + patch] += 1
    return acc / count
