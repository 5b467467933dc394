"""The port's host-side research tools against the JAX package's, on the
CPU: the offline evaluation CLI (research/dmri_hippo/evaluate.py), the
split generator (make_dmri_hippo_splits.py), the nnUNet export
(utils/nn_unet_convert.py through nn_unet/convert_dataset.py) and the
notebook widgets (visualizations/notebook.py), each on the same files or
subjects on both sides, with equal outputs."""
import json
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.dmri_hippo import evaluate as jevaluate
from research.dmri_hippo import make_dmri_hippo_splits as jsplits
from research.dmri_hippo.nn_unet import convert_dataset as jconvert
from segmentation_pipeline_torch.research.dmri_hippo import evaluate as tevaluate
from segmentation_pipeline_torch.research.dmri_hippo import make_dmri_hippo_splits as tsplits
from segmentation_pipeline_torch.research.dmri_hippo.nn_unet import convert_dataset as tconvert
from segmentation_pipeline_tpu.visualizations import notebook as jnotebook
from segmentation_pipeline_torch.visualizations import notebook as tnotebook
from test_torch_ensemble import model_pair
from test_torch_subject_folder import write_hippo_dataset

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hippo_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("hippo")
    write_hippo_dataset(root)
    return root


def test_evaluate_writes_jax_json(hippo_root, tmp_path):
    """Two prediction runs (noisy copies of the ground truth) evaluated in
    the validation mode: the results JSON equals JAX's."""
    rng = np.random.default_rng(8)
    predictions = tmp_path / "predictions"
    for run in ("run_a", "run_b"):
        with open(tmp_path / f"{run}.json", "w") as f:
            json.dump({"output_filename": f"{run}.nii.gz"}, f)
        for folder in sorted((hippo_root / "subjects").iterdir()):
            if not (folder / "whole_roi.nii.gz").exists():
                continue
            truth, affine = tsp.read_nifti(folder / "whole_roi.nii.gz")
            noisy = np.where(rng.random(truth.shape) < 0.05,
                             rng.integers(0, 3, truth.shape), truth).astype(np.int16)
            (predictions / "subjects" / folder.name).mkdir(parents=True, exist_ok=True)
            tsp.write_nifti(predictions / "subjects" / folder.name / f"{run}.nii.gz", noisy,
                            affine)
    for run in ("run_a", "run_b"):
        shutil.copy(tmp_path / f"{run}.json", predictions / f"{run}.json")
    outs = [tmp_path / "jax.json", tmp_path / "port.json"]
    for module, out in zip((jevaluate, tevaluate), outs):
        module.main(str(hippo_root), str(predictions), "validation", str(out))
    results = [json.loads(out.read_text()) for out in outs]
    assert sorted(results[0]) == ["run_a", "run_b"]
    assert "segmentation_eval/cbbrain_validation" in results[0]["run_a"]
    assert results[1] == results[0]


def _write_split_dataset(root):
    """A folder with the split generator's pools: 153 labeled, healthy,
    single-scan cbbrain subjects and 120 unlabeled ab300 ones, with ages and
    genders on a grid that fills every stratum (tiny volumes: only the
    attributes and the labels' presence matter)."""
    volume = np.zeros((1, 2, 2, 2), np.float32)
    for i in range(273):
        cbbrain = i < 153
        folder = root / "subjects" / (f"cbbrain_{i:03d}" if cbbrain else f"ab300_{i:03d}")
        folder.mkdir(parents=True)
        for name in ("mean_dwi", "md", "fa"):
            tsp.write_nifti(folder / f"{name}.nii.gz", volume, np.eye(4))
        if cbbrain:
            tsp.write_nifti(folder / "whole_roi.nii.gz", volume.astype(np.int16), np.eye(4))
        with open(folder / "attributes.json", "w") as f:
            json.dump({"protocol": "cbbrain" if cbbrain else "ab300", "pathologies": "None",
                       "rescan_id": "None", "age": float(20 + 8 * (i % 7)),
                       "gender": "M" if (i // 7) % 2 else "F"}, f)


def test_make_dmri_hippo_splits_writes_jax_splits(tmp_path, monkeypatch):
    roots = [tmp_path / "jax", tmp_path / "port"]
    _write_split_dataset(roots[0])
    shutil.copytree(roots[0], roots[1])
    monkeypatch.setattr(sys, "argv", ["make_dmri_hippo_splits", str(roots[0]), "--seed", "4"])
    jsplits.main()
    tsplits.main([str(roots[1]), "--seed", "4"])
    for name in ("cbbrain_test_subjects", "ab300_validation_subjects", "cross_validation_split"):
        written = [json.loads((r / "attributes" / f"{name}.json").read_text()) for r in roots]
        assert written[1] == written[0] and written[0], name
    assert len(json.loads((roots[1] / "attributes" / "cross_validation_split.json")
                          .read_text())) == 100


def test_nn_unet_export_matches_jax(hippo_root, tmp_path, monkeypatch):
    """convert_dataset --split-and-mirror: the same files, NIfTIs,
    dataset.json, subject names and splits."""
    outs = [tmp_path / "jax", tmp_path / "port"]
    monkeypatch.setattr(sys, "argv", ["convert_dataset", str(hippo_root), str(outs[0]),
                                      "--split-and-mirror"])
    jconvert.main()
    tconvert.main([str(hippo_root), str(outs[1]), "--split-and-mirror"])
    files = [sorted(p.relative_to(out) for p in out.rglob("*") if p.is_file()) for out in outs]
    assert files[1] == files[0] and len(files[0]) > 20
    for rel in files[0]:
        if rel.suffix == ".json":
            assert json.loads((outs[1] / rel).read_text()) == json.loads((outs[0] / rel).read_text())
        elif rel.suffix == ".pkl":
            got, want = (pickle.loads((out / rel).read_bytes()) for out in outs[::-1])
            assert [{k: list(v) for k, v in s.items()} for s in got] == \
                [{k: list(v) for k, v in s.items()} for s in want]
        else:
            (tdata, taffine), (jdata, jaffine) = (tsp.read_nifti(out / rel) for out in outs[::-1])
            assert tdata.dtype == jdata.dtype, rel
            np.testing.assert_array_equal(tdata, jdata, err_msg=str(rel))
            np.testing.assert_array_equal(taffine, jaffine, err_msg=str(rel))


def _pixels(figure):
    figure.canvas.draw()
    return np.asarray(figure.canvas.buffer_rgba())


class _Widgets:
    """ipywidgets whose ``interact`` renders one chosen configuration."""

    def __init__(self, **choice):
        self.choice = choice

    def interact(self, fn, **sliders):
        assert set(self.choice) <= set(sliders)
        return fn(**self.choice)


def test_notebook_widgets_match_jax(monkeypatch):
    """At the same slider values, vis_features draws JAX's figure pixel for
    pixel and vis_subject JAX's contour montage; vis_model gives JAX's
    activations (within 1e-5 of each one's max) under the same names for
    every module with weights, the parameter-free ones under the port's
    own names (its dropout is a function, its softmax the ``hypothesis``
    module)."""
    import matplotlib

    matplotlib.use("Agg")
    rng = np.random.default_rng(6)
    features = rng.normal(size=(3, 12, 10, 6)).astype(np.float32)
    monkeypatch.setitem(sys.modules, "ipywidgets",
                        _Widgets(channel=1, plane="Coronal", slice_id=4))
    np.testing.assert_array_equal(_pixels(tnotebook.vis_features(features)),
                                  _pixels(jnotebook.vis_features(features)))
    monkeypatch.setitem(sys.modules, "ipywidgets", _Widgets(plane="Axial", slice_id=4))

    x = rng.normal(size=(3, 16, 16, 8)).astype(np.float32)
    labels = np.zeros((1, 16, 16, 8), np.int32)
    labels[0, 4:10, 5:11, 2:6] = 1
    subjects = []
    for pkg in (jsp, tsp):
        s = pkg.Subject(name="sub-0")
        s["X"] = pkg.ScalarImage(tensor=x)
        s["mean_dwi"] = pkg.ScalarImage(tensor=x[:1])
        s["y"] = pkg.LabelMap(tensor=labels, label_values={"hippocampus": 1})
        subjects.append(s)
    montages = [module.vis_subject(s, "mean_dwi", target_label_map_name="y")
                for module, s in zip((jnotebook, tnotebook), subjects)]
    np.testing.assert_array_equal(np.asarray(montages[1]), np.asarray(montages[0]))

    jmodel, model = model_pair(3)
    jax_maps = jnotebook.vis_model(jmodel, subjects[0])
    port_maps = tnotebook.vis_model(model, subjects[1])
    renamed = {"hypothesis/__call__": "Softmax_0/__call__"}
    parameter_free = {k for k in jax_maps if "Dropout" in k} | set(renamed.values())
    assert {renamed.get(k, k) for k in port_maps} == set(jax_maps) - (parameter_free -
                                                                       set(renamed.values()))
    for name, value in port_maps.items():
        ref = jax_maps[renamed.get(name, name)]
        assert value.shape == ref.shape and value.ndim == 4, name
        assert np.abs(value - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1e-30), name
    assert set(tnotebook.vis_model(model, subjects[1], filter_pattern="conv0_0")) == \
        set(jnotebook.vis_model(jmodel, subjects[0], filter_pattern="conv0_0")) - parameter_free


def test_headless_widgets_render_the_first_plane(monkeypatch):
    """Without ipywidgets the port renders the midpoint of each range and
    the first entry of each list, where ipywidgets starts (the JAX
    package's fallback passes the whole list of planes and raises)."""
    import matplotlib

    matplotlib.use("Agg")
    features = np.random.default_rng(7).normal(size=(3, 12, 10, 6)).astype(np.float32)
    monkeypatch.setitem(sys.modules, "ipywidgets", None)
    with pytest.raises(TypeError):
        jnotebook.vis_features(features)
    headless = _pixels(tnotebook.vis_features(features))
    monkeypatch.setitem(sys.modules, "ipywidgets",
                        _Widgets(channel=1, plane="Saggital", slice_id=5))
    np.testing.assert_array_equal(headless, _pixels(tnotebook.vis_features(features)))
