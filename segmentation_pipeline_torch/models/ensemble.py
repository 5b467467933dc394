"""Ensembling and test-time augmentation wrappers, ported from
segmentation_pipeline_tpu/models/ensemble.py: ``EnsembleModels`` (e.g. CV
folds), ``EnsembleFlips`` (all 2^k flip combinations of the chosen spatial
dims) and ``EnsembleOrientations`` (6 permutations x 8 flips = 48
orientations), callables over channel-first (N, C, W, H, D) tensors that
wrap any model callable (SegModel, another ensemble, ...). Members run on
the device that ``x`` is on; nothing goes to the host.

Two execution modes:

- unrolled (default): each member is a separate forward;
- batched (``batched=True``): the members are folded into the batch and run
  in one forward (for EnsembleOrientations, the 8 flips of each permutation).
  In eval mode BatchNorm uses its running statistics and dropout is off, so
  folding changes no sample's arithmetic: the result is the unrolled one.

The JAX package's ``mesh=`` (sharding the folded batch over devices) and
``EnsembleAffines`` are not ported yet.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def parse_strategy(strategy: str) -> str:
    strategies = ("mean", "majority")
    if strategy not in strategies:
        raise ValueError(f"Ensembling strategy must be one of {strategies} not {strategy}")
    return strategy


def _majority(stacked: torch.Tensor, weights=None) -> torch.Tensor:
    """One-hot of the class with the most member votes, (N, C, ...) from
    (E, N, C, ...); ties go to the smallest class index (argmax of the
    per-class counts returns the first maximum). ``weights`` (E, 1, ...)
    counts only valid voters."""
    C = stacked.shape[2]
    votes = torch.argmax(stacked, dim=2)                # (E, N, ...)
    hits = [votes == c for c in range(C)]
    if weights is not None:
        hits = [h * weights for h in hits]
    counts = torch.stack([h.sum(dim=0) for h in hits], dim=1)
    winner = torch.argmax(counts, dim=1)                # (N, ...)
    return F.one_hot(winner, C).to(stacked.dtype).movedim(-1, 1)


def apply_strategy(predictions: Sequence[torch.Tensor], strategy: str) -> torch.Tensor:
    """predictions: list of (N, C, ...) probability tensors."""
    stacked = torch.stack(list(predictions))            # (E, N, C, ...)
    if strategy == "mean":
        return torch.mean(stacked, dim=0)
    if strategy == "majority":
        return _majority(stacked)
    raise RuntimeError(f"Invalid prediction strategy {strategy}")


def apply_strategy_masked(predictions: Sequence[torch.Tensor],
                          masks: Sequence[torch.Tensor],
                          strategy: str) -> torch.Tensor:
    """Combine (N, C, ...) member predictions under per-voxel validity masks
    (spatial shape, True where the member has a real prediction): masked
    mean, or majority among valid voters only."""
    stacked = torch.stack(list(predictions))            # (E, N, C, ...)
    w = torch.stack([m.to(stacked.dtype) for m in masks])[:, None, None]  # (E, 1, 1, ...)
    if strategy == "mean":
        denom = torch.clamp(w.sum(dim=0), min=1.0)
        return (stacked * w).sum(dim=0) / denom
    if strategy == "majority":
        return _majority(stacked, w[:, :, 0])
    raise RuntimeError(f"Invalid prediction strategy {strategy}")


class EnsembleModels:
    """Average / majority vote over a list of models (e.g. CV folds)."""

    def __init__(self, models: Sequence, strategy: str = "mean"):
        self.models = list(models)
        self.strategy = parse_strategy(strategy)

    def __call__(self, x):
        return apply_strategy([model(x) for model in self.models], self.strategy)


def _flip(x: torch.Tensor, dims) -> torch.Tensor:
    return torch.flip(x, dims=dims) if dims else x


class EnsembleFlips:
    """TTA over all flip combinations of the chosen spatial dims; each
    prediction is un-flipped before combining. ``batched=True`` folds the
    2^k flip members into the batch and runs them in one forward."""

    def __init__(self, model, strategy: str = "mean",
                 spatial_dims: Sequence[int] = (2, 3, 4), batched: bool = False):
        self.model = model
        self.strategy = parse_strategy(strategy)
        self.spatial_dims = tuple(spatial_dims)
        self.batched = batched
        self.flips = []
        for order in range(len(self.spatial_dims) + 1):
            self.flips += list(itertools.combinations(self.spatial_dims, order))

    def _members(self, x: torch.Tensor):
        """Predicted, un-flipped member outputs, one per flip combination."""
        if not self.batched:
            return [_flip(self.model(_flip(x, flip)), flip) for flip in self.flips]
        n = x.shape[0]
        y_all = self.model(torch.cat([_flip(x, flip) for flip in self.flips], dim=0))
        return [_flip(y_all[i * n:(i + 1) * n], flip) for i, flip in enumerate(self.flips)]

    def __call__(self, x):
        return apply_strategy(self._members(torch.as_tensor(x)), self.strategy)


class EnsembleOrientations:
    """TTA over all 6 spatial permutations x 8 flips = 48 orientations. In
    batched mode the 8 flips of each permutation (one shape) run as one
    forward: 48 member forwards become 6."""

    def __init__(self, model, strategy: str = "mean", batched: bool = False):
        self.model = model
        self.strategy = parse_strategy(strategy)
        self.batched = batched
        spatial_dims = (2, 3, 4)
        self.permutations = list(itertools.permutations(spatial_dims))
        self._flip_group = EnsembleFlips(model, strategy="mean", spatial_dims=spatial_dims,
                                         batched=batched)

    @property
    def flips(self):
        return self._flip_group.flips

    def __call__(self, x):
        x = torch.as_tensor(x)
        predictions = []
        for permutation in self.permutations:
            inverse_permutation = tuple(int(i) + 2 for i in np.argsort(permutation))
            x_permuted = x.permute(0, 1, *permutation)
            for y in self._flip_group._members(x_permuted):
                predictions.append(y.permute(0, 1, *inverse_permutation))
        return apply_strategy(predictions, self.strategy)
