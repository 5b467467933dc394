"""dmri_hippo's augmentation ablation with its DWI modes on the port, against
the JAX package on the CPU: the augmentation config's four modes build JAX's
loaders and training pipelines and give JAX's training subjects from the
same seed; the hybrid device cache's per-batch host stage
(training/hybrid_augment.py) splices the same regenerated mean_dwi channel
into the cached batch as JAX's; and run.py's ``debug`` and the DWI modes'
``augmentation_experiment`` (with and without the fast path) train on the
CPU."""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.dmri_hippo.configs import augmentation as jaugmentation
from segmentation_pipeline_tpu.data.device_cache import DeviceDataCache as JDeviceDataCache
from segmentation_pipeline_tpu.training.auto_augment import \
    derive_hybrid_augmentation as jderive
from segmentation_pipeline_tpu.training.hybrid_augment import \
    HybridHostAugment as JHybridHostAugment
from segmentation_pipeline_torch.data.device_cache import DeviceDataCache
from segmentation_pipeline_torch.research.dmri_hippo import run as trun
from segmentation_pipeline_torch.research.dmri_hippo.configs import augmentation as taugmentation
from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config as thippo
from segmentation_pipeline_torch.training.auto_augment import derive_hybrid_augmentation
from segmentation_pipeline_torch.training.hybrid_augment import HybridHostAugment
from test_torch_qsm_transforms import _assert_subjects_equal
from test_torch_subject_folder import write_hippo_dataset

torch.set_num_threads(2)

SMALL = dict(crop_shape=(16, 16, 8), filters=4)
# a short series: 2 volumes at b=0, 8 at b=500, 6 at b=1000
BVALS = (0.0,) * 2 + (500.0,) * 8 + (1000.0,) * 6


@pytest.fixture(scope="module")
def dwi_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("hippo-dwi")
    write_hippo_dataset(root)
    chip_smoke.write_full_dwi(root, 0, BVALS)
    return root


def _context(pkg, root, mode, **kwargs):
    config, extra = (jaugmentation, {}) if pkg is jsp else (taugmentation, {"device": "cpu"})
    return config.get_context(variables={"DATASET_PATH": str(root)}, augmentation_mode=mode,
                              **SMALL, **extra, **kwargs)


def _names(transform):
    sub = getattr(transform, "transforms", None)
    name = type(transform).__name__
    return [name, [_names(t) for t in sub]] if sub is not None else name


@pytest.mark.parametrize("mode", list(taugmentation.MODES))
def test_augmentation_modes_match_jax(dwi_root, mode):
    """Each mode: JAX's loaders and training pipeline, and, from the same
    host seed, JAX's first training subject (in the DWI modes its mean_dwi
    resynthesized from the series)."""
    subjects, loaders, pipelines = [], [], []
    for pkg in (jsp, tsp):
        context = _context(pkg, dwi_root, mode)
        definition = context.get_component_definition("dataset")["params"]
        loaders.append([type(loader).__name__ for loader in definition["subject_loader"].loaders])
        pipelines.append(_names(definition["transforms"]["training"]))
        assert context.config["augmentation_mode"] == mode
        context.init_components()
        pkg.seed_all(3)
        subjects.append(context.dataset.get_cohort_dataset("training")[0])
    assert loaders[0] == loaders[1] and pipelines[0] == pipelines[1]
    assert ("TensorLoader" in loaders[1]) == (mode in ("dwi_reconstruction", "combined"))
    _assert_subjects_equal(*subjects)


@pytest.fixture(scope="module")
def hybrid(dwi_root):
    """package -> (pretransformed training subjects, hybrid spec) of the
    combined mode's declared pipeline."""
    out = {}
    for pkg, derive in ((jsp, jderive), (tsp, derive_hybrid_augmentation)):
        context = _context(pkg, dwi_root, "combined")
        context.init_components()
        dataset = context.dataset.get_cohort_dataset("training")
        host_t, cfg, spec = derive(dataset.transform)
        assert cfg is not None and spec is not None
        dataset.set_transform(host_t)
        dataset.preload_and_transform_subjects()
        out[pkg] = dataset.subjects, spec
    return out


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_hybrid_host_augment_matches_jax(hybrid, dtype):
    """The cached batch of subjects (2, 0, 3) with mean_dwi regenerated from
    the same host seed: equal to JAX's spliced batch exactly (in bfloat16
    both round the same float32 block to nearest even)."""
    idx = [2, 0, 3]
    spliced = []
    for pkg, cache_cls, runtime_cls in ((jsp, JDeviceDataCache, JHybridHostAugment),
                                        (tsp, DeviceDataCache, HybridHostAugment)):
        subjects, spec = hybrid[pkg]
        if pkg is jsp:
            import jax.numpy as jnp

            x_dtype = None if dtype is None else jnp.bfloat16
            cache = cache_cls(subjects, x_dtype=x_dtype, expand_onehot=False)
            runtime = runtime_cls(subjects, spec, x_dtype=x_dtype)
        else:
            x_dtype = None if dtype is None else torch.bfloat16
            cache = cache_cls(subjects, x_dtype=x_dtype, device="cpu", expand_onehot=False)
            runtime = runtime_cls(subjects, spec, x_dtype=x_dtype, device="cpu")
        pkg.seed_all(11)
        X = runtime.apply(cache.gather(idx)["X"], idx)
        spliced.append(np.asarray(jnp.asarray(X, jnp.float32)) if pkg is jsp
                       else X.float().numpy())
    assert spliced[1].shape == (3, 16, 16, 8, 3)
    np.testing.assert_array_equal(spliced[1], spliced[0])


def test_splice_moves_only_the_regenerated_channel(hybrid):
    """Only mean_dwi's slot changes; the other cached channels stay as the
    cache holds them, and the upload is that one channel."""
    subjects, spec = hybrid[tsp]
    assert spec.image_order == ["mean_dwi"] and spec.n_channels == 1
    (offset, n), = [spec.slots["mean_dwi"]]
    cache = DeviceDataCache(subjects, device="cpu", expand_onehot=False)
    runtime = HybridHostAugment(subjects, spec, device="cpu")
    idx = [1, 2]
    before = cache.gather(idx)["X"].clone()
    tsp.seed_all(5)
    after = runtime.apply(cache.gather(idx)["X"], idx)
    others = [c for c in range(before.shape[-1]) if not offset <= c < offset + n]
    assert torch.equal(after[..., others], before[..., others])
    assert not torch.equal(after[..., offset], before[..., offset])
    assert runtime.upload_bytes == after[..., offset:offset + n].numel() * 4
    with pytest.raises(ValueError, match="image_channels"):
        bad = type(spec)(spec.peeled, spec.finishers, {"mean_dwi": (0, 2)}, ["mean_dwi"],
                         spec.host_inline)
        HybridHostAugment(subjects, bad, device="cpu")


@pytest.fixture
def small_hippo(monkeypatch):
    monkeypatch.setattr(thippo, "get_context", functools.partial(
        thippo.get_context, training_batch_size=2, **SMALL))


def _checkpoints(logs):
    [run_dir] = list(logs.iterdir())
    return sorted((run_dir / "checkpoints").iterdir())


def test_debug_trains_one_iteration(dwi_root, small_hippo, tmp_path):
    """run.py debug: the combined mode at batch 1, one iteration."""
    logs = tmp_path / "logs"
    args = trun.build_parser().parse_args(
        ["debug", str(dwi_root), str(logs), "--max-iterations", "1", "--device", "cpu"])
    args.func(args)
    assert len(_checkpoints(logs)) == 2


@pytest.mark.parametrize("fast", [False, True], ids=["default-path", "fast-path"])
@pytest.mark.parametrize("task_id", [10, 15], ids=["dwi_reconstruction", "combined"])
def test_dwi_grid_task_ids_train(dwi_root, small_hippo, tmp_path, capsys, task_id, fast):
    """augmentation_experiment_grid's DWI task ids (fold 0) train one
    iteration; with --tpu-fast-path through the hybrid device cache."""
    logs = tmp_path / "logs"
    argv = ["augmentation_experiment_grid", str(dwi_root), str(logs), "--task-id", str(task_id),
            "--max-iterations", "1", "--num-workers", "0", "--device", "cpu"]
    args = trun.build_parser().parse_args(argv + (["--tpu-fast-path"] if fast else []))
    args.func(args)
    assert (args.augmentation_mode, args.fold) == \
        ({10: "dwi_reconstruction", 15: "combined"}[task_id], 0)
    assert len(_checkpoints(logs)) == 2
    assert ("hybrid device cache" in capsys.readouterr().out) == fast


@pytest.mark.parametrize("task_id", range(20))
def test_every_grid_task_id_builds(dwi_root, small_hippo, tmp_path, monkeypatch, task_id):
    """Each of augmentation_experiment_grid's 20 task ids (4 modes x 5
    folds) builds its context and initializes its components on the CPU,
    the training itself left out (test_dwi_grid_task_ids_train trains)."""
    built = []

    def build_only(context, *args, **kwargs):
        context.init_components()
        built.append(context)

    monkeypatch.setattr(trun, "_train", build_only)
    args = trun.build_parser().parse_args(
        ["augmentation_experiment_grid", str(dwi_root), str(tmp_path / "logs"),
         "--task-id", str(task_id), "--device", "cpu"])
    args.func(args)
    [context] = built
    mode, fold = taugmentation.MODES[task_id // 5], task_id % 5
    assert (args.augmentation_mode, args.fold) == (mode, fold)
    assert context.config["augmentation_mode"] == mode and context.config["fold"] == fold
    loaders = context.get_component_definition("dataset")["params"]["subject_loader"].loaders
    assert (type(loaders[0]).__name__ == "ImageLoader" and loaders[0].image_name == "full_dwi") \
        == (mode in ("dwi_reconstruction", "combined"))
