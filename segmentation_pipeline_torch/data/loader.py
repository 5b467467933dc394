"""Data loaders: batches of Subjects, a patch queue and its samplers.

Ported from segmentation_pipeline_tpu/data/loader.py. A batch is a list of
Subjects (identity collate); a pool of workers runs the dataset's loading
and transforms ahead of the consumer, in the sampler's order: threads by
default (numpy and scipy release the GIL), or, with ``use_processes=True``,
processes, which also scale transforms that hold the GIL. Patch samplers
draw patch centres and cut each patch with a recorded ``Crop``, so its
history stays invertible. Shuffles draw from Python's ``random`` and
samplers from ``get_rng()``, as in the JAX package.

A dataset is any indexable object whose ``__getitem__`` returns a
transformed Subject. With processes it is pickled once into each worker
(prefer a lazy, not preloaded, dataset), items come back pickled, and each
worker reseeds the host RNG (``seed_all``). Workers start with forkserver
(spawn where it is missing), hide the card from themselves and never touch
CUDA. A loader keeps its pool across epochs; a factory keeps one per
dataset across the loaders it makes (a validation sweep makes a loader
each time) and drops its pools when pickled.
"""
from __future__ import annotations

import copy
import os
import queue as queue_mod
import random
from abc import ABC, abstractmethod
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Iterator, List, Sequence

import numpy as np

from ..core.subject import Subject
from ..transforms.base import get_rng, seed_all
from ..transforms.spatial import Crop

# ---------------------------------------------------------------------------
# process workers
# ---------------------------------------------------------------------------

_WORKER_DATASET = None


def _init_worker(dataset, seed_base: int):
    """Worker initializer: keeps the dataset, hides the card (workers do
    host work only) and reseeds the host RNG per process, so two workers
    never draw the same augmentations."""
    global _WORKER_DATASET
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _WORKER_DATASET = dataset
    seed_all((seed_base + os.getpid()) % (2 ** 32))


def _worker_fetch(i: int):
    return _WORKER_DATASET[i]


def _make_process_pool(dataset, num_workers: int) -> ProcessPoolExecutor:
    """A pool of ``num_workers`` processes holding ``dataset``. forkserver
    forks each worker from a clean server process (never from a parent with
    CUDA or threads running) that has imported this module once; spawn,
    where forkserver is missing, starts each one afresh. Both re-import the
    launching script in each worker, so a script that makes loaders with
    processes guards its body with ``if __name__ == "__main__":``."""
    import multiprocessing as mp

    if "forkserver" in mp.get_all_start_methods():
        context = mp.get_context("forkserver")
        context.set_forkserver_preload([__name__])
    else:
        context = mp.get_context("spawn")
    return ProcessPoolExecutor(max_workers=num_workers, mp_context=context,
                               initializer=_init_worker,
                               initargs=(dataset, random.getrandbits(31)))


class _PooledWorkers:
    """A loader's process pool: its own, made at first use and kept across
    epochs, or one a factory owns and shares (``pool``), which breakage
    reports to ``on_pool_broken``."""

    def __init__(self, pool=None, on_pool_broken=None):
        self._pool = pool
        self._owns_pool = pool is None
        self._on_pool_broken = on_pool_broken

    def _get_pool(self):
        if not (self.use_processes and self.num_workers > 0):
            return None
        if self._pool is None:
            self._pool = _make_process_pool(self.dataset, self.num_workers)
            self._owns_pool = True
        return self._pool

    def _discard_pool(self):
        """A worker died: drop the broken pool (reaped without waiting) so
        the next epoch makes a fresh one, and tell the factory."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        self._pool = None
        self._owns_pool = True
        if self._on_pool_broken is not None:
            self._on_pool_broken()

    def _items(self, order):
        return _PrefetchIterator(self.dataset, order, self.num_workers,
                                 use_processes=self.use_processes, pool=self._get_pool(),
                                 on_pool_broken=self._discard_pool)

    def close(self):
        if self._pool is not None and self._owns_pool:
            self._pool.shutdown(wait=True)
        self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


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
    """Dataset items in ``order``, fetched by ``num_workers`` threads (or,
    with ``use_processes``, processes: ``pool``, else a pool of its own for
    this pass) up to ``max(PREFETCH, 2 * num_workers)`` items ahead; the
    order is kept. With no workers the items are fetched in the caller's
    thread. When a worker process dies, ``on_pool_broken`` runs and the
    pass raises."""

    PREFETCH = 4

    def __init__(self, dataset, order: List[int], num_workers: int,
                 use_processes: bool = False, pool=None, on_pool_broken=None):
        self.dataset = dataset
        self.order = order
        self.num_workers = num_workers
        self.use_processes = use_processes
        self.pool = pool
        self.on_pool_broken = on_pool_broken
        self.prefetch = max(self.PREFETCH, num_workers * 2) if num_workers > 0 else 0

    def _pool_died(self, error):
        if self.on_pool_broken is not None:
            self.on_pool_broken()
        raise RuntimeError(
            "A loader worker process died. With use_processes=True workers start with "
            "forkserver or spawn, which re-import the launching script: an entry-point "
            "script must guard its body with `if __name__ == '__main__':` (as for torch "
            "DataLoader workers). If it does, the worker crashed (a signal, out of memory): "
            "rerun with PYTHONFAULTHANDLER=1 for its traceback. The broken pool was "
            "discarded; the next epoch starts a fresh one.") from error

    def __iter__(self):
        if self.num_workers <= 0:
            for i in self.order:
                yield self.dataset[i]
            return
        owns_pool = not self.use_processes or self.pool is None
        if not self.use_processes:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            fetch = self.dataset.__getitem__
        else:
            pool = self.pool or _make_process_pool(self.dataset, self.num_workers)
            fetch = _worker_fetch

        def submit(idx):
            try:
                futures.put(pool.submit(fetch, idx))
            except BrokenProcessPool as error:
                self._pool_died(error)

        try:
            futures = queue_mod.Queue()
            order_iter = iter(self.order)
            submitted = 0
            for idx in order_iter:
                submit(idx)
                submitted += 1
                if submitted == self.prefetch:
                    break
            while submitted > 0:
                fut = futures.get()
                submitted -= 1
                idx = next(order_iter, None)
                if idx is not None:
                    submit(idx)
                    submitted += 1
                try:
                    item = fut.result()
                except BrokenProcessPool as error:
                    self._pool_died(error)
                yield item
        finally:
            if owns_pool:
                pool.shutdown(wait=True, cancel_futures=True)


class SubjectsLoader(_PooledWorkers):
    """Lists of ``batch_size`` Subjects in the sampler's order."""

    def __init__(self, dataset, batch_size: int, sampler, num_workers: int = 0,
                 drop_last: bool = False, use_processes: bool = False, pool=None,
                 on_pool_broken=None):
        super().__init__(pool, on_pool_broken)
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.use_processes = use_processes

    def __iter__(self) -> Iterator[List[Subject]]:
        items = self._items(list(iter(self.sampler)))
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


class PatchQueue(_PooledWorkers):
    """tio.Queue's semantics: a shuffled buffer of patches, filled by taking
    ``samples_per_volume`` patches from each transformed subject (in a
    shuffled order, fetched by ``num_workers`` threads or processes) and
    emptied, in a shuffled order, whenever it holds ``max_length``, and at
    the end."""

    def __init__(self, dataset, max_length: int, samples_per_volume: int,
                 sampler: PatchSampler, num_workers: int = 0,
                 use_processes: bool = False, pool=None, on_pool_broken=None):
        super().__init__(pool, on_pool_broken)
        self.dataset = dataset
        self.max_length = max_length
        self.samples_per_volume = samples_per_volume
        self.sampler = sampler
        self.num_workers = num_workers
        self.use_processes = use_processes

    def __len__(self):
        return len(self.dataset) * self.samples_per_volume

    def __iter__(self) -> Iterator[Subject]:
        order = list(range(len(self.dataset)))
        random.shuffle(order)
        buffer: List[Subject] = []
        for subject in self._items(order):
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
    """Makes loaders. With ``use_processes`` it keeps one process pool per
    dataset (weakly keyed by identity) and lends it to every loader it
    makes, since starting workers costs seconds. The workers hold the
    dataset as it was pickled at first use: call ``close_pools`` after
    changing a dataset's indexing. Pools stay out of pickles (factories
    travel inside checkpoints)."""

    # the default of factories pickled before process workers were ported
    use_processes = False

    @abstractmethod
    def get_data_loader(self, dataset, batch_size: int, num_workers: int = 0):
        ...

    def _pool_for(self, dataset, num_workers: int):
        if not (self.use_processes and num_workers > 0):
            return None
        import weakref

        pools = self.__dict__.setdefault("_pools", {})
        entry = pools.get(id(dataset))
        if entry is not None:
            ref, pool = entry
            if ref() is dataset:  # not an id reused after a collection
                return pool
            pool.shutdown(wait=False)
        try:
            ref = weakref.ref(dataset)
        except TypeError:  # not weakly referable: each loader makes its own
            return None
        pool = _make_process_pool(dataset, num_workers)
        pools[id(dataset)] = (ref, pool)
        return pool

    def _drop_pool(self, dataset):
        self.__dict__.get("_pools", {}).pop(id(dataset), None)

    def close_pools(self):
        for _, pool in self.__dict__.get("_pools", {}).values():
            pool.shutdown(wait=True)
        self.__dict__.pop("_pools", None)

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_pools", None)
        return state


class StandardDataLoader(DataLoaderFactory):
    def __init__(self, sampler=SequentialSampler, use_processes: bool = False):
        self.sampler = sampler
        self.use_processes = use_processes

    def get_data_loader(self, dataset, batch_size: int, num_workers: int = 0):
        return SubjectsLoader(dataset=dataset, batch_size=batch_size,
                              sampler=self.sampler(dataset), num_workers=num_workers,
                              use_processes=self.use_processes,
                              pool=self._pool_for(dataset, num_workers),
                              on_pool_broken=lambda: self._drop_pool(dataset))


class PatchDataLoader(DataLoaderFactory):
    def __init__(self, max_length: int, samples_per_volume: int,
                 sampler: PatchSampler, use_processes: bool = False):
        self.max_length = max_length
        self.samples_per_volume = samples_per_volume
        self.sampler = sampler
        self.use_processes = use_processes

    def get_data_loader(self, dataset, batch_size: int, num_workers: int = 0):
        queue = PatchQueue(dataset, max_length=self.max_length,
                           samples_per_volume=self.samples_per_volume,
                           sampler=self.sampler, num_workers=num_workers,
                           use_processes=self.use_processes,
                           pool=self._pool_for(dataset, num_workers),
                           on_pool_broken=lambda: self._drop_pool(dataset))
        return _QueueLoader(queue, batch_size)
