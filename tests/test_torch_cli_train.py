"""The port's training CLIs (segmentation_pipeline_torch/research/dmri_hippo/
run.py, research/msseg2/run.py and the ablation config
configs/augmentation.py) against the JAX package's on the CPU: the parsers
take the JAX CLIs' arguments and defaults (and ``--device``), ``main``
trains two iterations at a small size (dmri_hippo on the default and the
fast path) and writes checkpoints that the port's serving CLIs load,
every flag whose feature waits for a ROADMAP item raises naming it before
any work is done, and the flags whose items were ported since
(--device-postprocess, cascade_experiment) run."""
import argparse
import functools
import json

import numpy as np
import pytest
import torch

import chip_smoke
import segmentation_pipeline_torch as tsp
from research.dmri_hippo import run as jrun
from research.dmri_hippo.configs import augmentation as jaugmentation
from research.msseg2 import run as jms_run
from segmentation_pipeline_torch.research.dmri_hippo import hippo_inference, run as trun
from segmentation_pipeline_torch.research.dmri_hippo.configs import augmentation as taugmentation
from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config as thippo
from segmentation_pipeline_torch.research.msseg2 import msseg2 as tmsseg2
from segmentation_pipeline_torch.research.msseg2 import run as tms_run
from segmentation_pipeline_torch.research.msseg2.competition import ms_inference
from test_torch_msseg2_trainer import write_dataset as write_msseg2_dataset
from test_torch_subject_folder import write_hippo_dataset

torch.set_num_threads(2)

MISSING = "/nonexistent/dataset"


def _options(parser):
    """dest -> (option strings, default, choices, type) of a parser's
    arguments, and of each subcommand's."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[name] = _options(sub)
        elif not isinstance(action, argparse._HelpAction):
            out[action.dest] = (tuple(action.option_strings), action.default,
                                tuple(action.choices or ()), action.type)
    return out


class _Parsed(Exception):
    pass


def _jax_msseg2_parser(monkeypatch):
    """research/msseg2/run.py's parser, taken as its main() parses."""
    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as parsed:
        jms_run.main()
    monkeypatch.undo()
    return parsed.value.args[0]


def test_parsers_take_the_jax_clis_arguments(monkeypatch):
    port = _options(trun.build_parser())
    jax = _options(jrun.build_parser())
    assert port.keys() == jax.keys()
    for command, options in jax.items():
        assert port[command].pop("device") == (("--device",), None, (), None), command
        assert port[command] == options, command
    port = _options(tms_run.build_parser())
    assert port.pop("device") == (("--device",), None, (), None)
    assert port == _options(_jax_msseg2_parser(monkeypatch))


@pytest.fixture(scope="module")
def hippo_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("hippo")
    write_hippo_dataset(root)
    return root


@pytest.fixture
def small_hippo(monkeypatch):
    monkeypatch.setattr(thippo, "get_context", functools.partial(
        thippo.get_context, crop_shape=(16, 16, 8), filters=4, training_batch_size=2))


def _checkpoints(logs):
    [run_dir] = list(logs.iterdir())
    return sorted((run_dir / "checkpoints").iterdir())


@pytest.mark.parametrize("fast", [False, True], ids=["default-path", "fast-path"])
def test_dmri_main_trains_and_serves(hippo_root, small_hippo, tmp_path, fast):
    """run.py main: two iterations on the CPU, checkpoints at 0 and 2 that
    hippo_inference serves as a fold ensemble, on the original grid."""
    logs = tmp_path / "logs"
    argv = ["main", str(hippo_root), str(logs), "--max-iterations", "2", "--num-workers", "0",
            "--device", "cpu"] + (["--tpu-fast-path"] if fast else [])
    args = trun.build_parser().parse_args(argv)
    args.func(args)
    checkpoints = _checkpoints(logs)
    assert [p.name for p in checkpoints] == [f"dmri-hippo-iter{i:08}.ckpt" for i in (0, 2)]
    out = tmp_path / "out"
    out.mkdir()
    hippo_inference.main(checkpoints[0].parent, hippo_root, "served", out_folder=str(out),
                         ensemble_flips=True, ensemble_folds=True, batched_tta=True,
                         cohort="cbbrain_validation", bf16=fast, device="cpu")
    served = sorted(out.glob("subjects/*/dmri-hippo-dmri-hippo.nii.gz"))
    assert len(served) == 3
    data, _ = tsp.read_nifti(served[0])
    assert data.shape == (1, 20, 18, 6) and set(np.unique(data)) <= {0, 1, 2}
    assert (out / "served.json").exists() and (out / "dmri-hippo-dmri-hippo.txt").exists()


def test_msseg2_main_trains_and_serves(tmp_path, monkeypatch):
    root = tmp_path / "msseg2"
    write_msseg2_dataset(root)
    monkeypatch.setattr(tms_run, "get_context", functools.partial(
        tmsseg2.get_context, patch_size=16, filters=(4, 4, 8)))
    logs = tmp_path / "logs"
    tms_run.main([str(root), str(logs), "--max-iterations", "2", "--num-workers", "0",
                  "--tpu-fast-path", "--device", "cpu"])
    checkpoints = _checkpoints(logs)
    assert [p.name for p in checkpoints] == [f"msseg2-iter{i:08}.ckpt" for i in (0, 2)]
    ms_inference.main([str(checkpoints[-1]), str(root), "mask.nii.gz", "--cohort", "validation",
                       "--out-folder", str(tmp_path / "out"), "--device-argmax",
                       "--device", "cpu"])
    [mask] = list((tmp_path / "out").glob("*/mask.nii.gz"))
    data, _ = tsp.read_nifti(mask)
    assert data.shape == (1, 40, 36, 30) and set(np.unique(data)) <= {0, 1}


def test_augmentation_modes_match_jax(hippo_root):
    """The ported modes rebuild the training pipeline as JAX's does."""
    for mode, expected in (("no_augmentation", 2), ("standard", 3)):
        pipelines = []
        for config, kwargs in ((jaugmentation, {}), (taugmentation, {"device": "cpu"})):
            context = config.get_context(variables={"DATASET_PATH": str(hippo_root)},
                                         augmentation_mode=mode, crop_shape=(16, 16, 8),
                                         filters=4, **kwargs)
            training = context.get_component_definition("dataset")["params"]["transforms"][
                "training"]
            pipelines.append([type(t).__name__ for t in training.transforms])
            assert context.config["augmentation_mode"] == mode
        assert pipelines[0] == pipelines[1] and len(pipelines[1]) == expected


def _run_args(command, *extra):
    return trun.build_parser().parse_args([command, MISSING, "/nonexistent/logs", *extra])


@pytest.mark.parametrize("call, item", [
    (lambda: hippo_inference.main(MISSING, MISSING, "r", tta_mesh=True), "item 10"),
], ids=["tta-mesh"])
def test_unported_flags_raise_naming_their_item(call, item):
    """Each raises before it reads anything: the paths do not exist."""
    with pytest.raises(NotImplementedError, match=item):
        call()


@pytest.fixture(scope="module")
def msseg2_checkpoint(tmp_path_factory):
    """An msseg2 context (patch 16, filters (4, 4, 8)) saved untrained, and
    its dataset."""
    root = tmp_path_factory.mktemp("msseg2-ckpt")
    write_msseg2_dataset(root)
    context = tmsseg2.get_context(device="cpu", variables={"DATASET_PATH": str(root)},
                                  patch_size=16, filters=(4, 4, 8))
    context.init_components()
    context.model.ensure_initialized()
    path = tmp_path_factory.mktemp("msseg2-model") / "msseg2.ckpt"
    context.save(path)
    return root, path


def _masks(folder):
    return {p.parent.name: tsp.read_nifti(p)[0] for p in sorted(folder.glob("*/mask.nii.gz"))}


@pytest.mark.parametrize("case", ["device-postprocess", "inference-device-postprocess",
                                  "cascade", "ensemble-affines"])
def test_lifted_flags_run(case, msseg2_checkpoint, hippo_root, small_hippo, tmp_path,
                          monkeypatch, capsys):
    """The flags that raised until their items were ported. ms_inference
    --device-postprocess through main: msseg2's default pipeline is
    geometric, so each subject takes the host cleanup and the masks equal
    --device-argmax's. inference() with device_postprocess on a tape of
    ConcatenateImages alone takes the fused path, against the host chain.
    cascade_experiment trains the cascade context two iterations on
    priors, and its checkpoints reload with the refined predictors.
    hippo_inference --ensemble-affines 2 --ensemble-flips --batched-tta,
    as parsed from its command line, serves labels on the scanner grid
    through affine TTA wrapped around flip TTA."""
    if case == "device-postprocess":
        root, ckpt = msseg2_checkpoint
        monkeypatch.setattr(ms_inference, "PATCH_SIZE", 16)
        for flag in ("--device-postprocess", "--device-argmax"):
            ms_inference.main([str(ckpt), str(root), "mask.nii.gz", "--cohort", "validation",
                               "--out-folder", str(tmp_path / flag), flag, "--device", "cpu"])
        assert "falling back to the host cleanup" in capsys.readouterr().out
        fused = _masks(tmp_path / "--device-postprocess")
        plain = _masks(tmp_path / "--device-argmax")
        assert fused.keys() == plain.keys() and fused
        for name in fused:
            np.testing.assert_array_equal(fused[name], plain[name])
    elif case == "inference-device-postprocess":
        from test_torch_device_confusion import _ms_dataset, lesion_model

        monkeypatch.setattr(ms_inference, "PATCH_SIZE", 16)
        for fused in (True, False):
            paths = ms_inference.inference(
                _ms_dataset(tsp, tmp_path / str(fused), False), lesion_model(tsp), "",
                "mask.nii.gz", device_argmax=True, device_postprocess=fused, device="cpu")
            assert [p for _, p in paths] == ["fused" if fused else "host"] * 2
        masks = [_masks(tmp_path / str(fused)) for fused in (True, False)]
        assert masks[0].keys() == masks[1].keys() and masks[0]
        for name in masks[0]:
            np.testing.assert_array_equal(masks[0][name], masks[1][name])
    elif case == "ensemble-affines":
        ensemble = tmp_path / "ensemble"
        ensemble.mkdir()
        context = thippo.get_context(device="cpu", variables={"DATASET_PATH": str(hippo_root)})
        context.init_components()
        context.model.ensure_initialized()
        context.save(ensemble / "fold0.ckpt")
        out = tmp_path / "out"
        out.mkdir()
        args = hippo_inference.build_parser().parse_args(
            [str(ensemble), str(hippo_root), "served", "--out-folder", str(out),
             "--ensemble-flips", "--ensemble-affines", "2", "--batched-tta", "--cohort",
             "cbbrain_validation", "--device", "cpu"])
        hippo_inference.main(**vars(args))
        served = sorted(out.glob("subjects/*/dmri-hippo.nii.gz"))
        assert len(served) == 3
        data, _ = tsp.read_nifti(served[0])
        assert data.shape == (1, 20, 18, 6) and set(np.unique(data)) <= {0, 1, 2}
        assert json.loads((out / "served.json").read_text())["ensemble_affines"] == 2
        [loaded] = hippo_inference.load_contexts(ensemble, hippo_root, True, True,
                                                 device="cpu", ensemble_affines=2)
        assert isinstance(loaded.model, tsp.EnsembleAffines) and loaded.model.batched
        assert isinstance(loaded.model.model, tsp.EnsembleFlips)
        assert len(loaded.model.matrices) == 2 and loaded.model.strategy == "majority"
    else:
        predictions = tmp_path / "predictions"
        chip_smoke.write_priors(str(hippo_root), str(predictions), 2)
        logs = tmp_path / "logs"
        args = trun.build_parser().parse_args(
            ["cascade_experiment", str(hippo_root), str(predictions), str(logs),
             "--max-iterations", "2", "--num-workers", "0", "--device", "cpu"])
        args.func(args)
        checkpoints = _checkpoints(logs)
        assert [p.name for p in checkpoints] == [f"dmri-hippo-iter{i:08}.ckpt" for i in (0, 2)]
        context = tsp.Context("cpu", file_path=str(checkpoints[-1]),
                              variables={"DATASET_PATH": str(hippo_root),
                                         "PREDICTIONS_PATH": str(predictions)})
        context.init_components()
        assert context.config["model_type"] is None
        assert context.trainer.validation_predictor.refine_image == "y_prior"
        assert type(context.model.module.hypothesis).__name__ == "StochasticMatrix"


def test_ported_grid_task_ids_train(hippo_root, small_hippo, tmp_path):
    """The grid's task ids of the ported modes run (no_augmentation, fold 1)."""
    args = trun.build_parser().parse_args(
        ["augmentation_experiment_grid", str(hippo_root), str(tmp_path / "logs"),
         "--task-id", "1", "--max-iterations", "1", "--num-workers", "0", "--device", "cpu"])
    args.func(args)
    assert (args.augmentation_mode, args.fold) == ("no_augmentation", 1)
    assert len(_checkpoints(tmp_path / "logs")) == 2
