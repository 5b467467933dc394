"""Data loaders: batches of Subjects, a patch queue and its samplers.

Ported from segmentation_pipeline_tpu/data/loader.py. A batch is a list of
Subjects (identity collate); a thread pool runs the dataset's loading and
transforms ahead of the consumer (numpy and scipy release the GIL), in the
sampler's order. Patch samplers draw patch centres and cut each patch with
a recorded ``Crop``, so its history stays invertible. Shuffles draw from
Python's ``random`` and samplers from ``get_rng()``, as in the JAX package.

A dataset is any indexable object whose ``__getitem__`` returns a
transformed Subject. Process workers (``use_processes=True``) are not
ported yet and raise.
"""
from __future__ import annotations

import copy
import queue as queue_mod
import random
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence

import numpy as np

from ..core.subject import Subject
from ..transforms.base import get_rng
from ..transforms.spatial import Crop


def _no_processes(use_processes: bool) -> None:
    if use_processes:
        raise NotImplementedError(
            "use_processes=True (loader worker processes) waits for the port of "
            "ROADMAP, Queue 1 item 7: process workers and the dataset fingerprint")


class RandomSampler:
    """Shuffled index order per epoch (torch's RandomSampler)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __iter__(self):
        ids = list(range(len(self.dataset)))
        random.shuffle(ids)
        return iter(ids)

    def __len__(self):
        return len(self.dataset)


class SequentialSampler:
    def __init__(self, dataset):
        self.dataset = dataset

    def __iter__(self):
        return iter(range(len(self.dataset)))

    def __len__(self):
        return len(self.dataset)


class _PrefetchIterator:
    """Dataset items in ``order``, fetched by ``num_workers`` threads up to
    ``max(PREFETCH, 2 * num_workers)`` items ahead; the order is kept. With
    no workers the items are fetched in the caller's thread."""

    PREFETCH = 4

    def __init__(self, dataset, order: List[int], num_workers: int,
                 use_processes: bool = False):
        _no_processes(use_processes)
        self.dataset = dataset
        self.order = order
        self.num_workers = num_workers
        self.prefetch = max(self.PREFETCH, num_workers * 2) if num_workers > 0 else 0

    def __iter__(self):
        if self.num_workers <= 0:
            for i in self.order:
                yield self.dataset[i]
            return
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            futures = queue_mod.Queue()
            order_iter = iter(self.order)
            submitted = 0
            for idx in order_iter:
                futures.put(pool.submit(self.dataset.__getitem__, idx))
                submitted += 1
                if submitted == self.prefetch:
                    break
            while submitted > 0:
                fut = futures.get()
                submitted -= 1
                idx = next(order_iter, None)
                if idx is not None:
                    futures.put(pool.submit(self.dataset.__getitem__, idx))
                    submitted += 1
                yield fut.result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


class SubjectsLoader:
    """Lists of ``batch_size`` Subjects in the sampler's order."""

    def __init__(self, dataset, batch_size: int, sampler, num_workers: int = 0,
                 drop_last: bool = False, use_processes: bool = False):
        _no_processes(use_processes)
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = num_workers
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[Subject]]:
        items = _PrefetchIterator(self.dataset, list(iter(self.sampler)), self.num_workers)
        batch = []
        for item in items:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


# ---------------------------------------------------------------------------
# Patch samplers (torchio's sampler semantics)
# ---------------------------------------------------------------------------

def _parse_patch_size(patch_size) -> np.ndarray:
    if isinstance(patch_size, int):
        return np.array([patch_size] * 3)
    return np.asarray(patch_size)


def extract_patch(subject: Subject, start: Sequence[int], patch_size) -> Subject:
    """A copy of ``subject`` cut to the patch at ``start`` by a recorded
    Crop, so that the patch's history stays invertible; ``location`` is
    (w0, h0, d0, w1, h1, d1), as torchio's GridSampler stamps it."""
    patch_size = _parse_patch_size(patch_size)
    spatial = np.array(subject.spatial_shape)
    start = np.asarray(start)
    fin = spatial - (start + patch_size)
    cropping = (int(start[0]), int(fin[0]), int(start[1]), int(fin[1]),
                int(start[2]), int(fin[2]))
    patch = copy.deepcopy(subject)
    Crop(cropping)(patch)
    patch["location"] = np.concatenate([start, start + patch_size]).astype(np.int64)
    return patch


class PatchSampler(ABC):
    def __init__(self, patch_size):
        self.patch_size = _parse_patch_size(patch_size)

    @abstractmethod
    def __call__(self, subject: Subject, num_patches: int) -> Iterator[Subject]:
        ...


class UniformSampler(PatchSampler):
    """Uniformly random patch positions (tio.UniformSampler)."""

    def __call__(self, subject, num_patches):
        spatial = np.array(subject.spatial_shape)
        max_start = spatial - self.patch_size
        if (max_start < 0).any():
            raise RuntimeError(
                f"Patch size {tuple(self.patch_size)} exceeds subject shape {tuple(spatial)}")
        rng = get_rng()
        for _ in range(num_patches):
            start = [int(rng.integers(0, m + 1)) for m in max_start]
            yield extract_patch(subject, start, self.patch_size)


class WeightedSampler(PatchSampler):
    """Patch centres drawn from a probability-map image (tio.WeightedSampler,
    msseg2's ``patch_probability``), restricted to the centres whose patch
    fits."""

    def __init__(self, patch_size, probability_map: str):
        super().__init__(patch_size)
        self.probability_map = probability_map

    def _raw_prob(self, subject) -> np.ndarray:
        """The unnormalized centre probabilities; a subclass hook."""
        return np.asarray(subject[self.probability_map].data)[0].astype(np.float64)

    def _valid_center_probs(self, subject) -> np.ndarray:
        prob = self._raw_prob(subject)
        spatial = np.array(prob.shape)
        if (spatial < self.patch_size).any():
            raise RuntimeError(
                f"Patch size {tuple(self.patch_size)} exceeds subject shape {tuple(spatial)}")
        # torchio's convention for even sizes: start = centre - size // 2, so
        # the valid centres are [size // 2, spatial - (size - size // 2)]
        lo = self.patch_size // 2
        hi = spatial - (self.patch_size - self.patch_size // 2)
        masked = np.zeros_like(prob)
        sl = tuple(slice(int(a), int(b) + 1) for a, b in zip(lo, hi))
        masked[sl] = prob[sl]
        total = masked.sum()
        if total <= 0:
            # an empty map: uniform over the valid centres
            masked[sl] = 1.0
            total = masked.sum()
        return masked / total

    def __call__(self, subject, num_patches):
        probs = self._valid_center_probs(subject)
        flat = probs.ravel()
        idx = get_rng().choice(flat.shape[0], size=num_patches, p=flat)
        centers = np.stack(np.unravel_index(idx, probs.shape), axis=1)
        for center in centers:
            yield extract_patch(subject, center - self.patch_size // 2, self.patch_size)


class LabelSampler(WeightedSampler):
    """Patch centres drawn from a label map (tio.LabelSampler): its positive
    voxels, or the weights given per label value."""

    def __init__(self, patch_size, label_name: str, label_probabilities=None):
        PatchSampler.__init__(self, patch_size)
        self.probability_map = label_name
        self.label_probabilities = label_probabilities

    def _raw_prob(self, subject):
        label = np.asarray(subject[self.probability_map].data)[0]
        if self.label_probabilities:
            prob = np.zeros(label.shape, dtype=np.float64)
            for value, weight in self.label_probabilities.items():
                prob[label == value] = weight
            return prob
        return (label > 0).astype(np.float64)


class PatchQueue:
    """tio.Queue's semantics: a shuffled buffer of patches, filled by taking
    ``samples_per_volume`` patches from each transformed subject (in a
    shuffled order, fetched by ``num_workers`` threads) and emptied, in a
    shuffled order, whenever it holds ``max_length``, and at the end."""

    def __init__(self, dataset, max_length: int, samples_per_volume: int,
                 sampler: PatchSampler, num_workers: int = 0,
                 use_processes: bool = False):
        _no_processes(use_processes)
        self.dataset = dataset
        self.max_length = max_length
        self.samples_per_volume = samples_per_volume
        self.sampler = sampler
        self.num_workers = num_workers

    def __len__(self):
        return len(self.dataset) * self.samples_per_volume

    def __iter__(self) -> Iterator[Subject]:
        order = list(range(len(self.dataset)))
        random.shuffle(order)
        buffer: List[Subject] = []
        for subject in _PrefetchIterator(self.dataset, order, self.num_workers):
            buffer.extend(self.sampler(subject, self.samples_per_volume))
            if len(buffer) >= self.max_length:
                random.shuffle(buffer)
                while buffer:
                    yield buffer.pop()
        random.shuffle(buffer)
        while buffer:
            yield buffer.pop()


class _QueueLoader:
    """Batches of patches out of a PatchQueue."""

    def __init__(self, queue: PatchQueue, batch_size: int):
        self.queue = queue
        self.batch_size = batch_size

    def __iter__(self):
        batch = []
        for patch in self.queue:
            batch.append(patch)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    def __len__(self):
        return (len(self.queue) + self.batch_size - 1) // self.batch_size


# ---------------------------------------------------------------------------
# Factories: the configuration surface
# ---------------------------------------------------------------------------

class DataLoaderFactory(ABC):
    @abstractmethod
    def get_data_loader(self, dataset, batch_size: int, num_workers: int = 0):
        ...


class StandardDataLoader(DataLoaderFactory):
    def __init__(self, sampler=SequentialSampler, use_processes: bool = False):
        _no_processes(use_processes)
        self.sampler = sampler

    def get_data_loader(self, dataset, batch_size: int, num_workers: int = 0):
        return SubjectsLoader(dataset=dataset, batch_size=batch_size,
                              sampler=self.sampler(dataset), num_workers=num_workers)


class PatchDataLoader(DataLoaderFactory):
    def __init__(self, max_length: int, samples_per_volume: int,
                 sampler: PatchSampler, use_processes: bool = False):
        _no_processes(use_processes)
        self.max_length = max_length
        self.samples_per_volume = samples_per_volume
        self.sampler = sampler

    def get_data_loader(self, dataset, batch_size: int, num_workers: int = 0):
        queue = PatchQueue(dataset, max_length=self.max_length,
                           samples_per_volume=self.samples_per_volume,
                           sampler=self.sampler, num_workers=num_workers)
        return _QueueLoader(queue, batch_size)
