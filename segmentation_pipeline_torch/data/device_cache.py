"""Device-resident training data: the host link leaves the hot loop.

Ported from segmentation_pipeline_tpu/data/device_cache.py. With a deterministic host pipeline (pretransformed once), the whole
training set is uploaded ONCE and each iteration's batch becomes an index
gather on the device; the host sends a few int64 indices per batch. Pair it
with the trainer's ``device_augmentation`` so that the augmentations still
vary every step.

Storage: X channels-last (S, W, H, D, C) in the compute dtype; labels that
are exactly one-hot as uint8 class ids (S, W, H, D), expanded back on the
device (bit-identical), other labels as float32 channels-last.
``DevicePatchCache`` adds each subject's patch-centre CDF and draws the
patches of a batch on the device.

On a ``mesh`` (parallel/mesh.py) the cache is replicated: each rank holds
all of it on its own device, is given the global batch's subject ids and
cuts its rows of the batch; patch centres are drawn for the global batch,
so the rows equal the one-device batch's.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


def is_exact_onehot(y: np.ndarray, axis: int = 1) -> bool:
    """True when ``y`` is exactly one-hot over ``axis`` with 1 < C <= 255:
    the one definition of "labels may cross to the device / sit there as
    uint8 class ids, bit-identical on expansion", shared by both caches and
    the trainer's compact upload."""
    n_classes = int(y.shape[axis])
    return (1 < n_classes <= 255
            and bool(np.all((y == 0) | (y == 1)))
            and bool(np.all(y.sum(axis=axis) == 1)))


def _host_x(X: np.ndarray, x_dtype) -> torch.Tensor:
    """Stacked channel-first X (S, C, W, H, D) -> channels-last float32,
    cast on the host to ``x_dtype`` (numpy has no bfloat16)."""
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(X, 1, -1), dtype=np.float32))
    return x if x_dtype is None else x.to(x_dtype)


def _labels(y: np.ndarray, is_onehot: bool) -> torch.Tensor:
    if is_onehot:
        return torch.from_numpy(np.argmax(y, axis=1).astype(np.uint8))  # (S, W, H, D)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(y, 1, -1), dtype=np.float32))


def _indices(indices, device) -> torch.Tensor:
    """Subject ids to the device without blocking the host (pinned, in
    order on the current stream)."""
    idx = torch.as_tensor(np.asarray(indices, np.int64))
    if device.type == "cuda":
        return idx.pin_memory().to(device, non_blocking=True)
    return idx


def _budget(total: int, max_bytes: int, what: str):
    if total > max_bytes:
        raise ValueError(
            f"{what} {total / 2 ** 30:.1f} GiB — beyond the device cache budget "
            f"({max_bytes / 2 ** 30:.1f} GiB). Disable device_cache or raise max_bytes")


class DeviceDataCache:
    """Whole volumes of uniform shape on the device; ``gather`` cuts a batch."""

    def __init__(self, subjects: Sequence, x_dtype=None, device=None, mesh=None,
                 max_bytes: int = 8 * 2 ** 30, expand_onehot: bool = True):
        device = resolve_device(device if mesh is None else mesh.device)
        self.mesh = mesh
        try:
            X = np.stack([np.asarray(s["X"].data) for s in subjects])
            y = np.stack([np.asarray(s["y"].data) for s in subjects])
        except ValueError as e:
            raise ValueError(
                "DeviceDataCache needs uniform subject shapes — add a "
                "CropOrPad/MinSizePad to the pipeline or disable "
                "device_cache") from e
        x = _host_x(X, x_dtype)
        self.n_classes = int(y.shape[1])
        self._is_onehot = is_exact_onehot(y, axis=1)
        y_store = _labels(y, self._is_onehot)
        total = x.nbytes + y_store.nbytes
        _budget(total, max_bytes, "Training set is")
        self.nbytes = total
        self.n_subjects = int(x.shape[0])
        self.device = device
        self.expand_onehot = expand_onehot
        self._X = x.to(device)
        self._y = y_store.to(device)

    def gather(self, indices):
        """Subject ids -> channels-last device batch {'X': (N, W, H, D, C)
        in the storage dtype, 'y': (N, W, H, D, C) float32}; with
        ``expand_onehot=False`` one-hot labels stay uint8 class ids
        (N, W, H, D), the input form of the device augmentation. On a mesh,
        ``indices`` are the global batch's and the batch is this rank's rows."""
        if self.mesh is not None:
            indices = list(indices)[self.mesh.rows(len(indices))]
        idx = _indices(indices, self.device)
        xb = self._X.index_select(0, idx)
        yb = self._y.index_select(0, idx)
        if self._is_onehot and self.expand_onehot:
            yb = F.one_hot(yb.long(), self.n_classes).float()
        return {"X": xb, "y": yb}


class DevicePatchCache:
    """Weighted patch sampling on the device over a cached training set.

    The pretransformed volumes sit on the device beside each subject's
    valid-centre CDF (float32, built by the sampler's own
    ``WeightedSampler._valid_center_probs``, or uniform over the centres
    whose patch fits for ``UniformSampler``); each batch draws its centres
    there by inverse CDF (searchsorted 'right') and gathers the patches. The
    host sends the subject-id stream of the queue's balance.

    Ragged volumes are zero-padded to the cohort's largest shape; padding
    has zero centre probability and every valid patch fits inside the true
    extent, so padded voxels never enter a patch.
    """

    def __init__(self, subjects: Sequence, sampler, x_dtype=None, device=None, mesh=None,
                 max_bytes: int = 12 * 2 ** 30, expand_onehot: bool = True):
        from .loader import UniformSampler, WeightedSampler

        device = resolve_device(device if mesh is None else mesh.device)
        self.mesh = mesh
        patch_size = np.asarray(sampler.patch_size)
        self.patch_size = tuple(int(p) for p in patch_size)

        Xs = [np.asarray(s["X"].data) for s in subjects]  # (C, W, H, D)
        ys = [np.asarray(s["y"].data) for s in subjects]
        shapes = np.array([x.shape[1:] for x in Xs])
        max_shape = shapes.max(axis=0)
        if (shapes.min(axis=0) < patch_size).any():
            raise ValueError(
                f"Patch size {self.patch_size} exceeds the smallest subject "
                f"shape {tuple(shapes.min(axis=0))}")

        def pad_to(vol, target):
            pad = [(0, 0)] + [(0, int(t - s)) for s, t in zip(vol.shape[1:], target)]
            return np.pad(vol, pad)

        x = _host_x(np.stack([pad_to(v, max_shape) for v in Xs]), x_dtype)
        y = np.stack([pad_to(v, max_shape) for v in ys])
        self.n_classes = int(y.shape[1])
        # one-hot on the UNPADDED labels: all-zero padded voxels would fail
        # the channel-sum test; they are never read, so class 0 there is
        # unobservable
        self._is_onehot = all(is_exact_onehot(v, axis=0) for v in ys)
        y_store = _labels(y, self._is_onehot)

        if isinstance(sampler, WeightedSampler):
            prob_fn = sampler._valid_center_probs
        elif isinstance(sampler, UniformSampler):
            def prob_fn(subject):
                spatial = np.array(subject.spatial_shape)
                lo = patch_size // 2
                hi = spatial - (patch_size - patch_size // 2)
                masked = np.zeros(tuple(spatial))
                masked[tuple(slice(int(a), int(b) + 1) for a, b in zip(lo, hi))] = 1.0
                return masked / masked.sum()
        else:
            raise ValueError(
                f"DevicePatchCache supports Uniform/Weighted/Label samplers, "
                f"not {type(sampler).__name__}")

        cdfs = []
        for s in subjects:
            prob = np.zeros(tuple(max_shape), np.float64)
            p = prob_fn(s)
            prob[tuple(slice(0, d) for d in p.shape)] = p
            cdf = np.cumsum(prob.ravel())
            with np.errstate(invalid="ignore"):  # an all-zero row: NaN, start 0
                cdf /= cdf[-1]
            cdfs.append(cdf.astype(np.float32))
        cdf = torch.from_numpy(np.stack(cdfs))  # (S, V)

        total = x.nbytes + y_store.nbytes + cdf.nbytes
        _budget(total, max_bytes, "Training set + CDFs are")
        self.nbytes = total
        self.n_subjects = int(x.shape[0])
        self.volume_shape = tuple(int(d) for d in max_shape)
        self.device = device
        self.expand_onehot = expand_onehot
        self._X, self._y, self._cdf = x.to(device), y_store.to(device), cdf.to(device)
        # a row without a positive probability (NaN after normalization)
        # takes centre 0, clipped to the first start
        self._valid = torch.isfinite(cdf[:, -1]).tolist()
        W, H, D = self.volume_shape
        self._half = torch.as_tensor(patch_size // 2, device=device)
        self._max_start = torch.as_tensor(
            [W - self.patch_size[0], H - self.patch_size[1], D - self.patch_size[2]],
            device=device)
        self._aranges = [torch.arange(p, device=device) for p in self.patch_size]

    def sample(self, subject_indices, generator: torch.Generator):
        """subject_indices: (N,) ids; generator: on the cache's device ->
        (batch, starts): batch = {'X': (N, pw, ph, pd, C), 'y': one-hot
        float32, or uint8 class ids (N, pw, ph, pd) with
        ``expand_onehot=False``}, starts = (N, 3) device patch starts. On a
        mesh the ids are the global batch's, the uniforms are drawn for all
        of them, and the batch and starts are this rank's rows."""
        u = torch.rand(len(subject_indices), generator=generator, device=generator.device)
        if self.mesh is not None:
            rows = self.mesh.rows(len(subject_indices))
            subject_indices, u = list(subject_indices)[rows], u[rows]
        return self.sample_at(subject_indices, u)

    def sample_at(self, subject_indices, u: torch.Tensor):
        """``sample`` at given uniforms u (N,) on the device: the centre of
        sample k is the first voxel whose CDF exceeds u[k]."""
        V = self._cdf.shape[1]
        flats = [torch.searchsorted(self._cdf[int(si)], u[k:k + 1], right=True)
                 if self._valid[int(si)] else torch.zeros(1, dtype=torch.long, device=u.device)
                 for k, si in enumerate(subject_indices)]
        flat = torch.cat(flats).clamp(0, V - 1)
        _, H, D = self.volume_shape
        center = torch.stack([flat // (H * D), flat % (H * D) // D, flat % D], 1)
        starts = torch.minimum(torch.clamp(center - self._half, min=0), self._max_start)
        si = _indices(subject_indices, self.device).view(-1, 1, 1, 1)
        w, h, d = (starts[:, i, None] + self._aranges[i] for i in range(3))
        window = (si, w[:, :, None, None], h[:, None, :, None], d[:, None, None, :])
        xb, yb = self._X[window], self._y[window]
        if self._is_onehot and self.expand_onehot:
            yb = F.one_hot(yb.long(), self.n_classes).float()
        return {"X": xb, "y": yb}, starts
