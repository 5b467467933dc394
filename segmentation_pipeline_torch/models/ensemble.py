"""Ensembling and test-time augmentation wrappers, ported from
segmentation_pipeline_tpu/models/ensemble.py: ``EnsembleModels`` (e.g. CV
folds), ``EnsembleFlips`` (all 2^k flip combinations of the chosen spatial
dims) and ``EnsembleOrientations`` (6 permutations x 8 flips = 48
orientations), callables over channel-first (N, C, W, H, D) tensors that
wrap any model callable (SegModel, another ensemble, ...), and
``EnsembleAffines`` (K random rotation and scale warps, each undone on the
probabilities, voting under each member's validity mask). Members run on
the device that ``x`` is on; nothing goes to the host.

Two execution modes:

- unrolled (default): each member is a separate forward;
- batched (``batched=True`` or ``mesh=...``): the members are folded into
  the batch and run in one forward (for EnsembleOrientations, the 8 flips of
  each permutation). In eval mode BatchNorm uses its running statistics and
  dropout is off, so folding changes no sample's arithmetic: the result is
  the unrolled one. With a ``mesh`` (parallel/mesh.py) the folded batch is
  padded with wrapped member rows to a multiple of the ranks, each rank runs
  its rows, and an all-gather gives every rank the whole folded output
  (padding dropped): every rank returns the same combination.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.augment import _affine_coords_oob, _sample, draw_affine_matrix
from ..parallel.mesh import all_gather_rows


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


def _run_folded(model, stacked: torch.Tensor, mesh) -> torch.Tensor:
    """``model`` on the folded member batch; on a mesh, this rank's rows of
    it padded with wrapped rows to a multiple of the ranks (the rows of a
    padding copy are dropped), gathered back on every rank."""
    if mesh is None:
        return model(stacked)
    total = stacked.shape[0]
    pad = (-total) % mesh.data_size
    if pad:
        wrap = torch.arange(pad, device=stacked.device) % total
        stacked = torch.cat([stacked, stacked[wrap]])
    y_all = all_gather_rows(model(stacked[mesh.rows(stacked.shape[0])]), mesh)
    return y_all[:total]


class EnsembleFlips:
    """TTA over all flip combinations of the chosen spatial dims; each
    prediction is un-flipped before combining. ``batched=True`` folds the
    2^k flip members into the batch and runs them in one forward; ``mesh``
    also shards that folded batch over the mesh's ranks."""

    def __init__(self, model, strategy: str = "mean",
                 spatial_dims: Sequence[int] = (2, 3, 4), batched: bool = False,
                 mesh=None):
        self.model = model
        self.strategy = parse_strategy(strategy)
        self.spatial_dims = tuple(spatial_dims)
        self.batched = batched or mesh is not None
        self.mesh = mesh
        self.flips = []
        for order in range(len(self.spatial_dims) + 1):
            self.flips += list(itertools.combinations(self.spatial_dims, order))

    def _members(self, x: torch.Tensor):
        """Predicted, un-flipped member outputs, one per flip combination."""
        if not self.batched:
            return [_flip(self.model(_flip(x, flip)), flip) for flip in self.flips]
        n = x.shape[0]
        y_all = _run_folded(self.model, torch.cat([_flip(x, flip) for flip in self.flips]),
                            self.mesh)
        return [_flip(y_all[i * n:(i + 1) * n], flip) for i, flip in enumerate(self.flips)]

    def __call__(self, x):
        return apply_strategy(self._members(torch.as_tensor(x)), self.strategy)


class EnsembleAffines:
    """TTA over K random affine warps (rotation and scale about the volume
    centre): warp the input, run the model, warp the probabilities back by
    the inverse matrix, and combine under a per-voxel validity mask, so
    voxels the inverse warp pulls from outside a member's grid do not vote.

    Member 0 is the identity when ``include_identity`` (the default), so
    every voxel has a valid vote. The matrices are drawn once, at
    construction, from a ``torch.Generator`` seeded with ``seed``, and kept
    in ``matrices`` (3x3 float32 numpy arrays). JAX's ``fold_in`` stream
    cannot be reproduced here, so the same ``seed`` draws other matrices
    than the JAX package; set ``matrices`` to reuse a given set.
    ``batched=True`` folds the K members into the batch and runs one
    forward, and ``mesh`` also shards that folded batch over the mesh's
    ranks. Out-of-bounds input voxels take ``pad_value``."""

    def __init__(self, model, num_members: int = 4, scales: float = 0.1,
                 degrees: float = 10.0, strategy: str = "mean", seed: int = 0,
                 include_identity: bool = True, pad_value: float = 0.0,
                 batched: bool = False, mesh=None):
        self.model = model
        self.strategy = parse_strategy(strategy)
        self.pad_value = float(pad_value)
        self.batched = batched or mesh is not None
        self.mesh = mesh
        matrices = [np.eye(3, dtype=np.float32)] if include_identity else []
        if num_members > len(matrices):
            drawn = draw_affine_matrix(torch.Generator().manual_seed(seed),
                                       num_members - len(matrices), scales=scales,
                                       degrees=degrees)
            matrices += [a.numpy().astype(np.float32) for a in drawn]
        self.matrices = matrices

    def _coords(self, spatial, device):
        """Per member, None for the identity, else (forward coords, forward
        out-of-bounds mask, inverse coords, inverse out-of-bounds mask)."""
        out = []
        for A in self.matrices:
            if np.allclose(A, np.eye(3)):
                out.append(None)
                continue
            cf, of = _affine_coords_oob(torch.tensor(A, device=device)[None], spatial)
            ci, oi = _affine_coords_oob(torch.tensor(np.linalg.inv(A), device=device)[None],
                                        spatial)
            out.append((cf, of[0], ci, oi[0]))
        return out

    def _warp_in(self, x, cf, of):
        """(N, C, W, H, D) warped by the member's forward coords, the pad
        out of bounds."""
        x_cl = x.movedim(1, -1)
        warped = _sample(x_cl, cf.expand(x.shape[0], *cf.shape[1:]))
        return torch.where(of[..., None], self.pad_value, warped).movedim(-1, 1)

    @staticmethod
    def _warp_back(y, ci):
        y_cl = y.movedim(1, -1)
        return _sample(y_cl, ci.expand(y.shape[0], *ci.shape[1:])).movedim(-1, 1)

    def __call__(self, x):
        x = torch.as_tensor(x)
        coords = self._coords(tuple(x.shape[2:]), x.device)
        ones = torch.ones(x.shape[2:], dtype=torch.bool, device=x.device)
        warp = lambda c: x if c is None else self._warp_in(x, c[0], c[1])  # noqa: E731
        if self.batched:
            n = x.shape[0]
            y_all = _run_folded(self.model, torch.cat([warp(c) for c in coords]), self.mesh)
            outputs = [y_all[i * n:(i + 1) * n] for i in range(len(coords))]
        else:
            outputs = [self.model(warp(c)) for c in coords]
        preds = [y if c is None else self._warp_back(y, c[2]) for y, c in zip(outputs, coords)]
        masks = [ones if c is None else ~c[3] for c in coords]
        return apply_strategy_masked(preds, masks, self.strategy)


class EnsembleOrientations:
    """TTA over all 6 spatial permutations x 8 flips = 48 orientations. In
    batched mode the 8 flips of each permutation (one shape) run as one
    forward: 48 member forwards become 6, each sharded over the ranks of a
    ``mesh``."""

    def __init__(self, model, strategy: str = "mean", batched: bool = False, mesh=None):
        self.model = model
        self.strategy = parse_strategy(strategy)
        self.batched = batched or mesh is not None
        self.mesh = mesh
        spatial_dims = (2, 3, 4)
        self.permutations = list(itertools.permutations(spatial_dims))
        self._flip_group = EnsembleFlips(model, strategy="mean", spatial_dims=spatial_dims,
                                         batched=batched, mesh=mesh)

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
