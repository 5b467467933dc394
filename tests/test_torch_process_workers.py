"""The port's loader process workers (``use_processes=True``, data/loader.py)
on the CPU, as the JAX package's tests/test_multiprocess_loader.py checks
its own: a tiny SubjectFolder, two workers. Order and content equal the
serial loader's (and JAX's, on a deterministic pipeline); the worker RNG
differs across processes; SubjectsLoader and PatchQueue run with process
batches; a factory shares one pool across its loaders and pickles without
it; a broken pool is discarded and the next loader recovers. JAX's timing
case (processes against a thread) is a claim about this host's speed, not
parity, and is left out."""
import os
import pickle

import numpy as np
import pytest

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch.data.loader import _PrefetchIterator
from test_torch_trainer import build_dataset


def _folder(pkg, root, transform=None):
    loader = pkg.ComposeLoaders([
        pkg.ImageLoader(glob_pattern="t1.*", image_name="t1", image_constructor=pkg.ScalarImage),
        pkg.ImageLoader(glob_pattern="seg.*", image_name="seg", image_constructor=pkg.LabelMap,
                        label_values={"fg": 1}),
    ])
    return pkg.SubjectFolder(root=str(root), subject_path="subjects", subject_loader=loader,
                             cohorts={"all": pkg.RequireAttributes(["t1"])},
                             transforms=None if transform is None else {"default": transform})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("process-workers")
    build_dataset(root, 5)
    return root


def _names(batches):
    return [s["name"] for b in batches for s in b]


def test_order_and_content_match_serial_and_jax(root):
    ds = _folder(tsp, root, tsp.RescaleIntensity((-1, 1), (0.5, 99.5)))
    jds = _folder(jsp, root, jsp.RescaleIntensity((-1, 1), (0.5, 99.5)))
    order = [3, 0, 4, 1, 2]
    loaded = list(_PrefetchIterator(ds, order, num_workers=2, use_processes=True))
    assert [s["name"] for s in loaded] == [f"sub-{i:02d}" for i in order]
    for i, got in zip(order, loaded):
        np.testing.assert_array_equal(got["t1"].data, ds[i]["t1"].data)
        np.testing.assert_allclose(got["t1"].data, np.asarray(jds[i]["t1"].data), rtol=1e-6)
        # the transform ran in the worker and its record came back
        assert [type(r.transform).__name__ for r in got.history] == ["RescaleIntensity"]


def test_worker_rng_differs_across_processes(root):
    """The same subject four times through two workers: each worker reseeds,
    so the noise differs."""
    ds = _folder(tsp, root, tsp.RandomNoise(std=(0.5, 0.5)))
    vols = [np.asarray(s["t1"].data)
            for s in _PrefetchIterator(ds, [0, 0, 0, 0], num_workers=2, use_processes=True)]
    assert max(np.abs(vols[0] - v).max() for v in vols[1:]) > 1e-3


def test_subjects_loader_and_patch_queue_run_process_batches(root):
    ds = _folder(tsp, root)
    loader = tsp.StandardDataLoader(sampler=tsp.SequentialSampler, use_processes=True)
    batches = list(loader.get_data_loader(ds, batch_size=2, num_workers=2))
    assert [len(b) for b in batches] == [2, 2, 1]
    assert _names(batches) == sorted(_names(batches))
    loader.close_pools()

    factory = tsp.PatchDataLoader(max_length=6, samples_per_volume=2,
                                  sampler=tsp.UniformSampler((8, 8, 4)), use_processes=True)
    patches = [p for b in factory.get_data_loader(ds, batch_size=2, num_workers=2) for p in b]
    factory.close_pools()
    assert len(patches) == 10
    assert all(np.asarray(p["t1"].data).shape == (1, 8, 8, 4) for p in patches)


def test_factory_shares_its_pool_and_pickles_without_it(root):
    """A sweep makes a loader per call: the pool lives on the factory, keyed
    by dataset, and a loader that does not own it leaves it running."""
    ds = _folder(tsp, root)
    factory = tsp.StandardDataLoader(sampler=tsp.SequentialSampler, use_processes=True)
    l1 = factory.get_data_loader(ds, batch_size=2, num_workers=2)
    l2 = factory.get_data_loader(ds, batch_size=2, num_workers=2)
    assert l1._pool is l2._pool and l1._pool is not None and not l1._owns_pool
    names = _names(l1)
    assert names == _names(l2) and len(names) == 5
    l1.close()
    l3 = factory.get_data_loader(ds, batch_size=5, num_workers=2)
    assert l3._pool is l2._pool and _names(l3) == names
    clone = pickle.loads(pickle.dumps(factory))
    assert "_pools" not in clone.__dict__ and clone.use_processes
    factory.close_pools()
    assert "_pools" not in factory.__dict__


def test_broken_pool_is_discarded_and_recovers(root):
    """A worker that dies breaks the pool: the pass raises, the factory
    drops the pool, and the next loader runs on a fresh one."""
    ds = _folder(tsp, root)
    factory = tsp.StandardDataLoader(sampler=tsp.SequentialSampler, use_processes=True)
    loader = factory.get_data_loader(ds, batch_size=2, num_workers=2)
    pool = loader._pool
    with pytest.raises(Exception):
        pool.submit(os._exit, 1).result(timeout=30)
    with pytest.raises(RuntimeError, match="worker process died"):
        list(loader)
    fresh = factory.get_data_loader(ds, batch_size=2, num_workers=2)
    assert fresh._pool is not pool and fresh._pool is not None
    assert len(_names(fresh)) == 5
    factory.close_pools()


STOP_SCRIPT = """
import sys
import chip_smoke
import segmentation_pipeline_torch as tsp

def _names(batches):
    return [s["name"] for b in batches for s in b]

loader = tsp.ImageLoader(glob_pattern="t1.*", image_name="t1", image_constructor=tsp.ScalarImage)
ds = tsp.SubjectFolder(root=sys.argv[1], subject_path="subjects", subject_loader=loader,
                       cohorts={"all": tsp.RequireAttributes(["t1"])})
closed, open_ = (tsp.StandardDataLoader(sampler=tsp.SequentialSampler, use_processes=True)
                 for _ in range(2))
assert len(_names(closed.get_data_loader(ds, batch_size=2, num_workers=2))) == 5
closed.close_pools()
helpers = chip_smoke.descendants()
loader = open_.get_data_loader(ds, batch_size=2, num_workers=2)
assert len(_names(loader)) == 5
workers = set(chip_smoke.descendants()) - set(helpers)
leaks = [pid for pid, _ in chip_smoke.stop_child_processes()]
assert chip_smoke.descendants() == []
print(len(helpers), len(workers), sorted(leaks) == sorted(workers))
"""


def test_chip_smoke_stops_the_worker_processes(root):
    """chip_smoke.py ends no run with a process of its own left running:
    after the pools are closed it stops the forkserver and the resource
    tracker, which would outlive it for a moment, and a pool left open is
    a leak, returned and killed."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", STOP_SCRIPT, str(root)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    # forkserver and resource tracker, stopped; the open pool's two workers
    # are the leaks, found and killed
    assert out.stdout.split()[-3:] == ["2", "2", "True"], out.stdout
