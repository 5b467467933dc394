"""The port's qsm configuration
(segmentation_pipeline_torch/research/qsm_deep_grey_matter) on the CPU: the
two tests of tests/test_qsm_and_tta.py mirrored on the port (the label
pipeline and two iterations of training; the memory recipe's microbatch 2
with accumulation, the fast path and bfloat16, re-entering ``train`` with
``force_continue``), and the same synthetic dataset through both packages'
``get_context`` giving equal X, y and label values."""
import json

import numpy as np
import pytest
import torch

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.qsm_deep_grey_matter import qsm_deep_grey_matter as jqsm
from segmentation_pipeline_torch.research.qsm_deep_grey_matter import qsm_deep_grey_matter as tqsm

torch.set_num_threads(2)

GRID = (40, 40, 24)
CROP = (4, 4, 4, 4, 0, 0)  # 32 x 32 x 24, divisible by 8
SMALL = dict(crop=CROP, filters=4, val_subjects=["Cb_Brain_000"])


def write_qsm_dataset(root, n=4, grid=GRID):
    """tests/test_qsm_and_tta.py's synthetic dataset (each of the 17
    structures planted as a small block, odd ids in the left half), written
    by the port's codec; the first two subjects also carry the internal
    capsule and pulvinar maps."""
    rng = np.random.default_rng(0)
    W, H, D = grid
    values = list(tqsm.DGM_LABEL_VALUES.values())
    for i in range(n):
        d = root / "subjects" / f"Cb_Brain_{i:03d}"
        d.mkdir(parents=True)
        dgm = np.zeros((1, W, H, D), np.int16)
        rs = np.random.default_rng(i)
        for v in values:
            cx = rs.integers(2, W // 2 - 4) if v % 2 == 1 else rs.integers(W // 2, W - 6)
            cy = rs.integers(2, H - 6)
            cz = rs.integers(2, D - 5)
            dgm[:, cx:cx + 3, cy:cy + 3, cz:cz + 2] = v
        t1 = rng.normal(size=(1, W, H, D)).astype(np.float32) + (dgm > 0) * 2.0
        qsm = rng.normal(size=(1, W, H, D)).astype(np.float32) + (dgm > 0)
        tsp.write_nifti(d / "MPRAGE.nii.gz", t1, np.eye(4))
        tsp.write_nifti(d / "QSM.nii.gz", qsm, np.eye(4))
        tsp.write_nifti(d / "vB_PS_r.nii.gz", dgm, np.eye(4))
        if i < 2:
            tsp.write_nifti(d / "IC.nii.gz", (dgm == 17).astype(np.int16) * 17, np.eye(4))
            tsp.write_nifti(d / "pulv.nii.gz", np.isin(dgm, (7, 8)).astype(np.int16) * dgm,
                            np.eye(4))


@pytest.fixture(scope="module")
def qsm_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("qsm")
    write_qsm_dataset(root)
    return root


def test_label_pipeline_and_training(qsm_root, tmp_path):
    """tests/test_qsm_and_tta.py::TestQsmConfig::test_label_pipeline_and_training
    on the port."""
    context = tqsm.get_context(device="cpu", variables={"DATASET_PATH": str(qsm_root)},
                               **SMALL)
    context.init_components()
    assert len(context.dataset) == 4

    s = context.dataset[0]
    # ventricles and dentate removed, L/R merged, sequential to <= 9 classes
    y = np.asarray(s["y"].data)
    assert y.shape[0] == 10  # one-hot with num_classes=10
    assert s["X"].data.shape[0] == 2
    label_values = s["dgm"]["label_values"]
    assert "left_ventricle" not in label_values
    assert max(label_values.values()) <= 9

    logger = tsp.FileLogger(str(tmp_path))
    context.trainer.train(context, max_iterations=2, logger=logger)
    metrics = [json.loads(line) for line in open(logger.run_dir / "metrics.jsonl")]
    assert len(metrics) == 2
    assert np.isfinite(metrics[-1]["loss"])


def _params(context):
    return {k: v.detach().clone() for k, v in context.model.params.items()}


def test_single_chip_fit_recipe(qsm_root, tmp_path, capsys):
    """tests/test_qsm_and_tta.py::TestQsmConfig::test_single_chip_fit_recipe
    on the port: microbatch=2 with accumulate_steps=2, tpu_fast_path (remat,
    the device cache, the device augmentation derived from a deterministic
    pipeline: none) and bfloat16 compute. Parameters move only every second
    micro-step, the accumulation carries across train() re-entry with
    force_continue, and the master weights stay float32."""
    context = tqsm.get_context(device="cpu", variables={"DATASET_PATH": str(qsm_root)},
                               tpu_fast_path=True, microbatch=2, compute_dtype="bfloat16",
                               **SMALL)
    context.init_components()
    assert context.trainer.training_batch_size == 2
    assert context.model.module.remat is True

    logger = tsp.FileLogger(str(tmp_path))
    context.trainer.train(context, max_iterations=2, logger=logger)
    optimizer = context.trainer._train_state.opt_state
    assert isinstance(optimizer, tsp.MultiSteps)
    assert (optimizer.mini_step, optimizer.gradient_step) == (0, 1)
    p2 = _params(context)
    # micro-step 3 only banks its gradients...
    context.trainer.train(context, max_iterations=1, logger=logger, force_continue=True)
    assert context.trainer._train_state.opt_state is optimizer
    assert (optimizer.mini_step, optimizer.gradient_step) == (1, 1)
    p3 = _params(context)
    assert all(torch.equal(p2[k], p3[k]) for k in p2), \
        "params moved on a banked accumulation micro-step"
    # ...and micro-step 4 applies the averaged update
    context.trainer.train(context, max_iterations=1, logger=logger, force_continue=True)
    p4 = _params(context)
    assert not all(torch.equal(p3[k], p4[k]) for k in p3), \
        "params never moved across full accumulation windows"
    assert (optimizer.mini_step, optimizer.gradient_step) == (0, 2)
    assert all(p.dtype == torch.float32 for p in p4.values())
    assert context.trainer.max_score_iteration == 3  # force_continue reset it
    out = capsys.readouterr().out
    assert "declares no stochastic transforms" in out


def test_both_contexts_give_the_same_subjects(qsm_root):
    """JAX's get_context and the port's over one dataset: every subject's X
    and y equal exactly after the default pipeline, the label values too."""
    datasets = []
    for pkg, config, kwargs in ((jsp, jqsm, {}), (tsp, tqsm, {"device": "cpu"})):
        context = config.get_context(variables={"DATASET_PATH": str(qsm_root)}, **SMALL,
                                     **kwargs)
        context.init_components()
        datasets.append(context.dataset)
    assert [s["name"] for s in datasets[0].subjects] == [s["name"] for s in datasets[1].subjects]
    for i in range(len(datasets[0])):
        js, ts = datasets[0][i], datasets[1][i]
        assert sorted(js.keys()) == sorted(ts.keys())
        for name in ("X", "y", "dgm"):
            assert ts[name].data.dtype == js[name].data.dtype, name
            np.testing.assert_array_equal(ts[name].data, js[name].data, err_msg=name)
            np.testing.assert_array_equal(ts[name].affine, js[name].affine, err_msg=name)
        assert ts["dgm"]["label_values"] == js["dgm"]["label_values"]
        assert ts["y"]["label_values"] == js["y"]["label_values"]
        assert ts["X"].data.shape == (2, 32, 32, 24)


def test_recipe_checkpoint_restores_the_accumulation(qsm_root, tmp_path):
    """A checkpoint the recipe's trainer saves in the middle of an
    accumulation window (after micro-step 3) restores its MultiSteps into a
    fresh Context: counters, accumulated gradients and Adam's moments as
    they were."""
    context = tqsm.get_context(device="cpu", variables={"DATASET_PATH": str(qsm_root)},
                               microbatch=2, **SMALL)
    context.init_components()
    logger = tsp.FileLogger(str(tmp_path))
    context.trainer.train(context, max_iterations=3, logger=logger)
    live = context.trainer._train_state.opt_state
    assert (live.mini_step, live.gradient_step) == (1, 1)
    logger.close()
    [last] = sorted((logger.run_dir / "checkpoints").iterdir())[-1:]
    restored = tsp.Context("cpu", file_path=str(last), variables={"DATASET_PATH": str(qsm_root)})
    restored.init_components()
    optimizer = restored.trainer._optimizer_for(restored.model, restored.optimizer)
    assert isinstance(optimizer, tsp.MultiSteps)
    assert (optimizer.mini_step, optimizer.gradient_step) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(optimizer.acc_grads, live.acc_grads))
    params = list(restored.model.params.values())
    for p, q in zip(params, context.model.params.values()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(optimizer.optimizer.state[p][key], live.optimizer.state[q][key])
