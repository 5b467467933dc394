"""The port's serving CLIs against the JAX package's, on the CPU, from JAX
checkpoints converted by ``convert_jax_checkpoint``: research/dmri_hippo/
hippo_inference.py ``main`` (two folds, flip TTA batched, fold majority),
research/msseg2/competition/ms_inference.py ``inference`` and the root
run_inference.py ``main`` (``test_time_augmentation`` at 8 orientations)
on datasets written to disk at a small size. Each prediction before the
inversion is recorded on both sides: labels agree outside near-ties (as
tests/test_torch_hippo_tta.py defines them), and where they agree
everywhere the NIfTIs are equal voxel for voxel, the report text equal and
the settings JSON equal apart from the paths. Also the competition entry
``ms_run`` (a subprocess running the port's ms_inference) on one FLAIR
pair, and the fused-cleanup check on both packages' tapes."""
import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import run_inference as jrun_inference
import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.dmri_hippo import hippo_inference as jhippo_inference
from research.dmri_hippo.configs import main_config as jhippo
from research.msseg2 import msseg2 as jmsseg2
from research.msseg2.competition import ms_inference as jms_inference
from segmentation_pipeline_torch import prediction as tpred
from segmentation_pipeline_torch import run_inference as trun_inference
from segmentation_pipeline_torch.models import state_dict_to_flax
from segmentation_pipeline_torch.models import ensemble as tens
from segmentation_pipeline_torch.research.dmri_hippo import hippo_inference as thippo_inference
from segmentation_pipeline_torch.research.msseg2.competition import ms_inference as tms_inference
from segmentation_pipeline_torch.utils.jax_checkpoint import convert_jax_checkpoint
from test_torch_ensemble import near_ties
from test_torch_msseg2_trainer import write_dataset as write_msseg2_dataset
from test_torch_patch_predict import TIE
from test_torch_subject_folder import write_hippo_dataset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CROP, FILTERS = (16, 16, 8), 4
MS_PATCH, MS_FILTERS = 16, (4, 4, 8)
COHORT = "cbbrain_validation"


def recording(monkeypatch, *classes):
    """Record a copy of each y_pred that ``predict`` of ``classes`` attaches,
    by class."""
    records = {cls: [] for cls in classes}
    for cls in classes:
        predict = cls.predict

        def recorded(self, model, subjects, label_attributes=None, predict=predict, cls=cls):
            subjects, batch = predict(self, model, subjects, label_attributes)
            records[cls] += [np.array(s["y_pred"].data) for s in subjects]
            return subjects, batch
        monkeypatch.setattr(cls, "predict", recorded)
    return records


def write_checkpoints(config, root, folder, states, **sizes):
    """JAX checkpoints of ``config`` at ``states`` (the port's state dicts),
    untrained, in ``folder``; and their conversions in ``folder``-torch."""
    folder.mkdir()
    for i, state in enumerate(states):
        context = config.get_context(variables={"DATASET_PATH": str(root)}, **sizes)
        context.init_components()
        context.model.load_state_dict(state_dict_to_flax(state))
        context.save(folder / f"fold{i}.ckpt")
    converted = folder.parent / f"{folder.name}-torch"
    convert_jax_checkpoint(folder, converted)
    return folder, converted


def hippo_state(seed):
    model = tsp.SegModel(tsp.NestedResUNet(3, 2, filters=FILTERS), seed=seed, device="cpu")
    model.ensure_initialized()
    state = model.module.state_dict()
    rng = np.random.default_rng(seed)
    for key, value in state.items():  # BatchNorm statistics off their init values
        if key.endswith("running_mean"):
            value.copy_(torch.from_numpy(rng.normal(0, 0.1, value.shape).astype(np.float32)))
        elif key.endswith("running_var"):
            value.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, value.shape).astype(np.float32)))
    return state


@pytest.fixture(scope="module")
def hippo(tmp_path_factory):
    root = tmp_path_factory.mktemp("hippo")
    write_hippo_dataset(root)
    jfolder, tfolder = write_checkpoints(jhippo, root, tmp_path_factory.mktemp("ckpt") / "dmri",
                                         [hippo_state(s) for s in (1, 2)], crop_shape=CROP,
                                         filters=FILTERS)
    return root, jfolder, tfolder


def _crop_labels_agree(jax_probs, port_probs, ties):
    for j, p, tie in zip(jax_probs, port_probs, ties):
        assert j.shape == p.shape
        np.testing.assert_array_equal(np.argmax(p, 0)[~tie], np.argmax(j, 0)[~tie])
    return all(np.array_equal(np.argmax(p, 0), np.argmax(j, 0))
               for j, p in zip(jax_probs, port_probs))


def test_hippo_inference_main_matches_jax(hippo, tmp_path, monkeypatch):
    root, jfolder, tfolder = hippo
    records = recording(monkeypatch, jsp.StandardPredict, tsp.StandardPredict)
    kwargs = dict(run_name="run", cohort=COHORT, batch_size=2, ensemble_flips=True,
                  ensemble_folds=True, batched_tta=True)
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    jhippo_inference.main(jfolder, root, out_folder=str(tmp_path / "jax"), **kwargs)
    thippo_inference.main(tfolder, root, out_folder=str(tmp_path / "port"), device="cpu",
                          **kwargs)

    # near-ties of the port's fold-and-flip members, in crop space
    contexts = [tsp.Context("cpu", file_path=f, variables={"DATASET_PATH": str(root)})
                for f in sorted(tfolder.iterdir())]
    for c in contexts:
        c.init_components()
    subjects = list(contexts[0].dataset.get_cohort_dataset(COHORT))
    x = tsp.collate_subjects(subjects, ["X"], device="cpu")["X"]
    members = []
    for c in contexts:
        flips = tens.EnsembleFlips(c.model, "majority", spatial_dims=(3, 4), batched=True)
        members += [tpred.reverse_split_and_flip(y)
                    for y in flips._members(tpred.split_and_flip(x))]
    ties = near_ties(members)
    assert ties.mean() < 0.01, ties.mean()
    jax_probs, port_probs = records[jsp.StandardPredict], records[tsp.StandardPredict]
    assert len(jax_probs) == len(port_probs) == len(subjects) == 3
    agree = _crop_labels_agree(jax_probs, port_probs, ties)

    name = "dmri-hippo-dmri-hippo"
    for s in subjects:
        for suffix in ("_before_processing", ""):
            files = [tmp_path / side / "subjects" / s["name"] / f"{name}{suffix}.nii.gz"
                     for side in ("jax", "port")]
            (jdata, jaffine), (tdata, taffine) = (jsp.read_nifti(f) for f in files)
            assert tdata.shape == jdata.shape == (1, 20, 18, 6) and tdata.dtype == jdata.dtype
            np.testing.assert_array_equal(taffine, jaffine)
            if agree:
                np.testing.assert_array_equal(tdata, jdata)
    reports = [(tmp_path / side / f"{name}.txt").read_text() for side in ("jax", "port")]
    assert reports[1].count("Filled") == 3
    if agree:
        assert reports[1] == reports[0]
    settings = [json.loads((tmp_path / side / "run.json").read_text()) for side in ("jax", "port")]
    paths = ("ensemble_path", "dataset_path", "out_folder")
    assert {k: v for k, v in settings[1].items() if k not in paths} == \
        {k: v for k, v in settings[0].items() if k not in paths}
    assert settings[1]["out_folder"] == str(tmp_path / "port")


def test_hippo_inference_tta_mesh_through_the_launcher(hippo, tmp_path):
    """``--tta-mesh``: the port's hippo_inference over 2 gloo ranks started
    by ``launch_multihost`` (each rank runs its rows of every folded flip
    batch, rank 0 writes) against the port's one-process run and JAX's CLI
    with the same flags: the port's two runs write the same NIfTIs voxel
    for voxel, the same report and the same settings apart from the flag;
    JAX's labels agree outside near-ties. JAX's own run is without
    --tta-mesh, whose answer GSPMD keeps equal to it: its eager ops on
    sharded arrays over 8 host devices can abort a loaded test worker, and
    tests/test_torch_mesh.py holds the ensembles to JAX's 2- and 4-device
    meshes."""
    root, jfolder, tfolder = hippo
    args = ["--cohort", COHORT, "--batch-size", "2", "--ensemble-flips", "--ensemble-folds",
            "--batched-tta", "--device", "cpu"]
    outs = {side: tmp_path / side for side in ("mesh", "one", "jax")}
    for out in outs.values():
        out.mkdir()
    done = subprocess.run(
        [sys.executable, "-m", "segmentation_pipeline_torch.research.scripts.launch_multihost",
         "--num-processes", "2", "--timeout", "60", "--",
         "segmentation_pipeline_torch.research.dmri_hippo.hippo_inference", str(tfolder),
         str(root), "run", "--out-folder", str(outs["mesh"]), "--tta-mesh", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    thippo_inference.main(tfolder, root, "run", out_folder=str(outs["one"]), cohort=COHORT,
                          batch_size=2, ensemble_flips=True, ensemble_folds=True,
                          batched_tta=True, device="cpu")
    jhippo_inference.main(jfolder, root, "run", out_folder=str(outs["jax"]), cohort=COHORT,
                          batch_size=2, ensemble_flips=True, ensemble_folds=True,
                          batched_tta=True)
    name = "dmri-hippo-dmri-hippo"
    subjects = sorted(p.name for p in (outs["one"] / "subjects").iterdir())
    assert len(subjects) == 3
    for subject in subjects:
        for suffix in ("_before_processing", ""):
            (mesh, _), (one, _), (ref, _) = (
                tsp.read_nifti(outs[side] / "subjects" / subject / f"{name}{suffix}.nii.gz")
                for side in ("mesh", "one", "jax"))
            np.testing.assert_array_equal(mesh, one)
            assert mesh.shape == ref.shape and (mesh != ref).mean() < 0.01
    assert (outs["mesh"] / f"{name}.txt").read_text() == (outs["one"] / f"{name}.txt").read_text()
    settings = [json.loads((outs[side] / "run.json").read_text()) for side in outs]
    drop = ("out_folder", "tta_mesh", "ensemble_path", "dataset_path")
    assert settings[0]["tta_mesh"] and not settings[1]["tta_mesh"]
    assert all({k: v for k, v in s.items() if k not in drop}
               == {k: v for k, v in settings[1].items() if k not in drop} for s in settings)


def test_run_inference_matches_jax_at_8_orientations(hippo, tmp_path, monkeypatch):
    """run_inference's main (one fold, 8 orientations through
    test_time_augmentation, holes removed, written on the original grid):
    each orientation's prediction agrees outside its near-ties, and the
    NIfTIs are equal where every orientation agrees."""
    root, jfolder, tfolder = hippo
    records = recording(monkeypatch, jsp.StandardPredict, tsp.StandardPredict)
    args = ["--orientation-count", "8", "--cohort", COHORT]
    monkeypatch.setattr(sys, "argv", ["run_inference.py", str(jfolder / "fold0.ckpt"), str(root),
                                      "tta.nii.gz", "--out-folder", str(tmp_path / "jax"), *args])
    jrun_inference.main()
    trun_inference.main([str(tfolder / "fold0.ckpt"), str(root), "tta.nii.gz", "--out-folder",
                         str(tmp_path / "port"), "--device", "cpu", *args])
    jax_probs, port_probs = records[jsp.StandardPredict], records[tsp.StandardPredict]
    assert len(jax_probs) == len(port_probs) == 3 * 8
    ties = []
    for p in port_probs:
        top2 = np.sort(p, axis=0)[-2:]
        ties.append(top2[1] - top2[0] < TIE)
    assert np.mean([t.mean() for t in ties]) < 0.01
    agree = _crop_labels_agree(jax_probs, port_probs, ties)
    assert len(trun_inference.get_test_time_transforms()) == 48
    for folder in sorted((tmp_path / "jax").iterdir()):
        (jdata, jaffine), (tdata, taffine) = (
            jsp.read_nifti(tmp_path / side / folder.name / "tta.nii.gz") for side in ("jax", "port"))
        assert tdata.shape == jdata.shape == (1, 20, 18, 6)
        np.testing.assert_array_equal(taffine, jaffine)
        assert set(np.unique(tdata)) <= {0, 1}
        if agree:
            np.testing.assert_array_equal(tdata, jdata)


@pytest.fixture(scope="module")
def msseg2(tmp_path_factory):
    root = tmp_path_factory.mktemp("msseg2")
    write_msseg2_dataset(root)
    module = chip_smoke.msseg2_network(MS_FILTERS)
    state = chip_smoke.msseg2_state(np.random.default_rng(21), module)
    jfolder, tfolder = write_checkpoints(jmsseg2, root, tmp_path_factory.mktemp("ckpt") / "ms",
                                         [state], patch_size=MS_PATCH, filters=MS_FILTERS)
    return root, jfolder, tfolder


def _loaded(pkg, folder, root):
    kwargs = {"device": "cpu"} if pkg is tsp else {}
    context = pkg.Context(file_path=str(folder / "fold0.ckpt"),
                          variables={"DATASET_PATH": str(root)}, **kwargs)
    context.keep_components(("model", "dataset"))
    context.init_components()
    return context


def test_ms_inference_matches_jax(msseg2, tmp_path, monkeypatch):
    """ms_inference.inference on the validation subject: the model-space
    prediction agrees outside near-ties, the mask equals JAX's where it
    agrees everywhere; --device-argmax through ``main`` gives the same
    mask."""
    root, jfolder, tfolder = msseg2
    records = recording(monkeypatch, jsp.PatchPredict, tsp.PatchPredict)
    for pkg, module, folder in ((jsp, jms_inference, jfolder), (tsp, tms_inference, tfolder)):
        context = _loaded(pkg, folder, root)
        dataset = context.dataset.get_cohort_dataset("validation")
        kwargs = {"device": "cpu"} if pkg is tsp else {}
        module.inference(dataset, context.model, str(tmp_path / pkg.__name__), "mask.nii.gz",
                         **kwargs)
    [jax_probs], [port_probs] = records[jsp.PatchPredict], records[tsp.PatchPredict]
    assert port_probs.shape == jax_probs.shape and port_probs.shape[0] == 2
    clear = np.abs(port_probs[1] - port_probs[0]) >= TIE
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(port_probs.argmax(0)[clear], jax_probs.argmax(0)[clear])
    [name] = [p.name for p in (tmp_path / "segmentation_pipeline_tpu").iterdir()]
    (jdata, jaffine), (tdata, taffine) = (
        jsp.read_nifti(tmp_path / side / name / "mask.nii.gz")
        for side in ("segmentation_pipeline_tpu", "segmentation_pipeline_torch"))
    assert tdata.shape == jdata.shape == (1, 40, 36, 30) and tdata.dtype == jdata.dtype
    np.testing.assert_array_equal(taffine, jaffine)
    if np.array_equal(port_probs.argmax(0), jax_probs.argmax(0)):
        np.testing.assert_array_equal(tdata, jdata)

    tms_inference.main([str(tfolder), str(root), "argmax.nii.gz", "--cohort", "validation",
                        "--out-folder", str(tmp_path / "argmax"), "--device-argmax",
                        "--device", "cpu"])
    argmax, _ = jsp.read_nifti(tmp_path / "argmax" / name / "argmax.nii.gz")
    np.testing.assert_array_equal(argmax, tdata)


def test_ms_run_stages_and_serves_a_flair_pair(msseg2, tmp_path):
    """The competition entry in a subprocess on the CPU: one raw FLAIR pair
    staged with an all-ones brain mask, served by the port's ms_inference;
    the mask equals ms_inference.inference's on the staged folder."""
    root, _, tfolder = msseg2
    subject = sorted(p for p in root.iterdir() if p.is_dir())[0]
    out = tmp_path / "out.nii.gz"
    subprocess.run([sys.executable, "-m",
                    "segmentation_pipeline_torch.research.msseg2.competition.ms_run",
                    "-t1", str(subject / "flair_time01.nii.gz"),
                    "-t2", str(subject / "flair_time02.nii.gz"), "-o", str(out),
                    "-d", str(tmp_path / "data"), "--ensemble-path", str(tfolder),
                    "--device", "cpu"], cwd=ROOT, check=True, timeout=300,
                   capture_output=True)
    staged = tmp_path / "data" / "input" / "raw_data"
    mask, _ = tsp.read_nifti(staged / "01" / "brain_mask.nii.gz")
    assert mask.dtype == np.int16 and (mask == 1).all()
    context = _loaded(tsp, tfolder, staged)
    tms_inference.inference(context.dataset, context.model, str(tmp_path / "again"),
                            "mask.nii.gz", device="cpu")
    (data, affine), (again, again_affine) = (
        tsp.read_nifti(p) for p in (out, tmp_path / "again" / "01" / "mask.nii.gz"))
    assert data.shape == (1, 40, 36, 30)
    np.testing.assert_array_equal(data, again)
    np.testing.assert_array_equal(affine, again_affine)


def test_fused_cleanup_check_matches_jax(msseg2):
    """_fused_cleanup_is_exact on the same tapes: msseg2's default pipeline
    (geometric records: not exact) and the model-I/O stage alone
    (intensity, concatenation, renaming, one-hot: exact)."""
    root, jfolder, tfolder = msseg2
    for stage, expected in ((None, False), (1, True)):
        answers = []
        for pkg, module, folder in ((jsp, jms_inference, jfolder),
                                    (tsp, tms_inference, tfolder)):
            dataset = _loaded(pkg, folder, root).dataset.get_cohort_dataset("validation")
            if stage is not None:
                dataset.set_transform(dataset.transform.transforms[stage])
            answers.append(module._fused_cleanup_is_exact(dataset[0]))
        assert answers == [expected, expected]


def test_ms_to_raw_grid_reports_the_cleanup(msseg2):
    """The cleanup's counts come back with the mask: CLEANUP_CHAIN's order."""
    root, _, tfolder = msseg2
    context = _loaded(tsp, tfolder, root)
    dataset = context.dataset.get_cohort_dataset("validation")
    subject, raw = dataset[0], copy.deepcopy(dataset.subjects[0])
    label, report = tms_inference.ms_inference(
        subject, raw, context.model, tms_inference.competition_predictor(device="cpu"))
    assert [op for op, _ in tms_inference.CLEANUP_CHAIN] == ["remove_holes",
                                                              "remove_small_components"]
    assert len(report) == 2 and all(n >= 0 for n in report)
    assert label.data.dtype == np.int32 and label.spatial_shape == raw.get_first_image().spatial_shape
