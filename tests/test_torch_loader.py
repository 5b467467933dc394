"""The port's data loaders against the JAX package's, on the CPU at one seed
(``seed_all`` in each package: samplers draw from ``get_rng()``, shuffles
from Python's ``random``): the centres of WeightedSampler, UniformSampler
and LabelSampler, PatchQueue's order, SubjectsLoader's batches and one
PatchDataLoader batch as msseg2's trainer builds it; thread workers keep
the order; process workers raise."""
import copy

import numpy as np
import pytest

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_tpu.data import loader as jloader
from segmentation_pipeline_torch.data import loader as tloader

GRID = (14, 12, 10)
PATCH = (6, 5, 4)


def _subjects(pkg, n=5, seed=0):
    """Subjects with an image X, a label map y and a probability map."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = pkg.Subject(name=f"s{i}")
        s["X"] = pkg.ScalarImage(tensor=rng.normal(size=(2, *GRID)).astype(np.float32))
        labels = (rng.uniform(size=(1, *GRID)) > 0.9).astype(np.int32)
        labels[0, 7, 6, 5] = 2
        s["y"] = pkg.LabelMap(tensor=labels)
        prob = rng.uniform(size=(1, *GRID)).astype(np.float32) ** 4
        s["patch_probability"] = pkg.ScalarImage(tensor=prob)
        out.append(s)
    return out


class Dataset:
    """A list-backed dataset: each item a copy of a subject."""

    def __init__(self, subjects):
        self.subjects = subjects

    def __len__(self):
        return len(self.subjects)

    def __getitem__(self, i):
        return copy.deepcopy(self.subjects[i])


def _locations(patches):
    return [tuple(int(v) for v in p["location"]) for p in patches]


def _patches_equal(port, ref):
    assert _locations(port) == _locations(ref)
    for p, r in zip(port, ref):
        assert p.name == r.name
        for key in ("X", "y", "patch_probability"):
            np.testing.assert_array_equal(p[key].data, r[key].data)
            np.testing.assert_array_equal(p[key].affine, r[key].affine)
        assert [type(t.transform).__name__ for t in p.history] == ["Crop"]


SAMPLERS = {
    "weighted": lambda m: m.WeightedSampler(PATCH, "patch_probability"),
    "weighted_cube": lambda m: m.WeightedSampler(4, "patch_probability"),
    "uniform": lambda m: m.UniformSampler(PATCH),
    "label": lambda m: m.LabelSampler(PATCH, "y"),
    "label_probabilities": lambda m: m.LabelSampler(PATCH, "y", {1: 1.0, 2: 50.0}),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_centres_match_jax(name):
    out = {}
    for pkg, module in ((jsp, jloader), (tsp, tloader)):
        pkg.seed_all(4)
        subject = _subjects(pkg, 1)[0]
        out[pkg] = list(SAMPLERS[name](module)(subject, 7))
    _patches_equal(out[tsp], out[jsp])
    assert all(p["X"].data.shape[1:] == tuple(np.broadcast_to(PATCH if name != "weighted_cube"
                                                              else 4, 3))
               for p in out[tsp])


@pytest.mark.parametrize("num_workers", [0, 2])
def test_patch_queue_order_matches_jax(num_workers):
    """Subjects in a shuffled order, two patches each, a buffer of 4 emptied
    in a shuffled order whenever it fills, and at the end; thread workers
    keep that order."""
    out = {}
    for pkg, module in ((jsp, jloader), (tsp, tloader)):
        pkg.seed_all(8)
        queue = module.PatchQueue(Dataset(_subjects(pkg)), max_length=4, samples_per_volume=2,
                                  sampler=module.WeightedSampler(PATCH, "patch_probability"),
                                  num_workers=num_workers)
        out[pkg] = list(queue)
        assert len(queue) == 10
    _patches_equal(out[tsp], out[jsp])


def test_patch_data_loader_batch_matches_jax():
    """msseg2's trainer's loader (``PatchDataLoader(max_length=100,
    samples_per_volume=1, WeightedSampler(patch, "patch_probability"))``,
    batch 4): the first batch and the one after it."""
    out = {}
    for pkg in (jsp, tsp):
        pkg.seed_all(2)
        factory = pkg.PatchDataLoader(max_length=100, samples_per_volume=1,
                                      sampler=pkg.WeightedSampler(PATCH, "patch_probability"))
        loader = factory.get_data_loader(Dataset(_subjects(pkg)), 4)
        assert len(loader) == 2
        out[pkg] = [patch for batch in loader for patch in batch]
        assert [len(batch) for batch in loader] == [4, 1]
    _patches_equal(out[tsp], out[jsp])


@pytest.mark.parametrize("sampler", ["RandomSampler", "SequentialSampler"])
def test_subjects_loader_matches_jax(sampler):
    out = {}
    for pkg in (jsp, tsp):
        pkg.seed_all(3)
        loader = pkg.StandardDataLoader(sampler=getattr(pkg, sampler)).get_data_loader(
            Dataset(_subjects(pkg)), 2)
        out[pkg] = [[s.name for s in batch] for batch in loader]
    assert out[tsp] == out[jsp]
    assert sorted(sum(out[tsp], [])) == [f"s{i}" for i in range(5)]


def test_thread_workers_keep_the_order():
    """Items fetched by threads come back in the sampler's order, with more
    workers than items ahead and a slow item first."""
    import time

    class Slow(Dataset):
        def __getitem__(self, i):
            if i == 0:
                time.sleep(0.05)
            return super().__getitem__(i)

    subjects = _subjects(tsp, 6)
    order = [0, 5, 2, 3, 1, 4]
    got = [s.name for s in tloader._PrefetchIterator(Slow(subjects), order, num_workers=3)]
    assert got == [f"s{i}" for i in order]
    loader = tloader.SubjectsLoader(Slow(subjects), 4, tloader.SequentialSampler(subjects),
                                    num_workers=2)
    assert [[s.name for s in b] for b in loader] == [["s0", "s1", "s2", "s3"], ["s4", "s5"]]


def test_process_workers_raise():
    sampler = tsp.WeightedSampler(PATCH, "patch_probability")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tsp.PatchDataLoader(100, 1, sampler, use_processes=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tsp.StandardDataLoader(use_processes=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tloader.PatchQueue(Dataset([]), 4, 1, sampler, use_processes=True)
