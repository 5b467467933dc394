"""The port's evaluators against the JAX package's on the same subjects:
SegmentationEvaluator (the joint histogram by ``np.bincount`` against the
JAX package's native pass, the float fallback), LabelMapEvaluator with
dmri_hippo's age curves, ContourImageEvaluator (grids, slice choices and
the rendered image, pixel for pixel), and LabeledTensor's and the subject
tables' conversions. Host numpy on both sides: every stat is held equal
exactly."""
import random

import numpy as np
import pandas as pd
import pytest

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_tpu.evaluators import contour_image_evaluator as jcontour
from segmentation_pipeline_tpu.evaluators import segmentation_evaluator as jseg
from segmentation_pipeline_torch.evaluators import contour_image_evaluator as tcontour
from segmentation_pipeline_torch.evaluators import segmentation_evaluator as tseg
from segmentation_pipeline_torch.research.dmri_hippo.configs.main_config import CURVE_PARAMS

LABELS = {"left_whole": 1, "right_whole": 2}
GRID = (18, 16, 12)


def _subjects(pkg, n=3, seed=0, dtype=np.int32):
    """Subjects with a target and a prediction label map (ids 0..3, 3 not a
    named label), an image and an age."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        target = np.zeros((1, *GRID), dtype)
        target[0, 3:8, 4:10, 3:9] = 1
        target[0, 10:15, 4:10, 3:9] = 2
        pred = target.copy()
        flip = rng.random(target.shape) < 0.1
        pred[flip] = rng.integers(0, 4, int(flip.sum()))
        s = pkg.Subject(name=f"s{i}", age=30.0 + 7 * i)
        s["mean_dwi"] = pkg.ScalarImage(tensor=rng.normal(size=(1, *GRID)).astype(np.float32))
        s["y_eval"] = pkg.LabelMap(tensor=target, label_values=dict(LABELS))
        s["y_pred_eval"] = pkg.LabelMap(tensor=pred, label_values=dict(LABELS))
        out.append(s)
    return out


def _assert_equal_nested(t, j):
    """Nested dicts of floats equal exactly, nan equal to nan."""
    if isinstance(j, dict):
        assert t.keys() == j.keys()
        for key in j:
            _assert_equal_nested(t[key], j[key])
    else:
        assert t == j or (np.isnan(t) and np.isnan(j)), (t, j)


def _assert_same_result(t, j):
    np.testing.assert_array_equal(t["summary_stats"].data, j["summary_stats"].data)
    assert t["summary_stats"].dim_keys == j["summary_stats"].dim_keys
    _assert_equal_nested(t["summary_stats"].to_dict(), j["summary_stats"].to_dict())
    pd.testing.assert_frame_equal(t["subject_stats"].to_dataframe(), j["subject_stats"])


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.float32])
def test_segmentation_evaluator_matches_jax(dtype):
    """Integer maps through the joint histogram, float maps through the
    per-label reductions; every stat equal, nan and inf included."""
    out = {pkg: pkg.SegmentationEvaluator("y_pred_eval", "y_eval")(
        _subjects(pkg, dtype=dtype)) for pkg in (jsp, tsp)}
    _assert_same_result(out[tsp], out[jsp])
    assert out[tsp]["subject_stats"]["dice"].shape == (6,)


def test_joint_histogram_matches_the_native_pass():
    """Values outside the table (negative, past its end) fall into the last
    bucket, as in the JAX package's native pass."""
    rng = np.random.default_rng(1)
    target = rng.integers(-2, 9, (4, 5, 6)).astype(np.int32)
    pred = rng.integers(-2, 9, (4, 5, 6)).astype(np.int32)
    lut = np.array([3, 0, 1, 3, 2], np.int32)
    joint = tseg.joint_histogram(target, pred, lut, 3)
    bucket = lambda v: lut[v] if 0 <= v < len(lut) else 3  # noqa: E731
    expected = np.zeros((4, 4), np.int64)
    for t, p in zip(target.reshape(-1), pred.reshape(-1)):
        expected[bucket(t), bucket(p)] += 1
    np.testing.assert_array_equal(joint, expected)
    from segmentation_pipeline_tpu.native import confusion_joint_hist_native
    native = confusion_joint_hist_native(target, pred, lut, 3)
    if native is not None:  # the JAX package's library, where it built
        np.testing.assert_array_equal(joint, native.reshape(joint.shape))


def test_stats_from_joint_matches_jax():
    joint = np.array([[5, 1, 0], [2, 7, 1], [0, 0, 0]], np.int64)
    _assert_equal_nested(tseg.stats_from_joint(joint, ["a", "b"]),
                         jseg.stats_from_joint(joint, ["a", "b"]))


def test_empty_cohort_gives_an_empty_table():
    for pkg in (jsp, tsp):
        out = pkg.SegmentationEvaluator("y_pred_eval", "y_eval")([])
        assert len(out["subject_stats"]) == 0
    assert list(out["subject_stats"].to_dataframe().columns)[:2] == ["subject", "label"]


def test_label_map_evaluator_matches_jax():
    """dmri_hippo's ``predicted_label_eval``: volumes and the errors
    against the age curves."""
    stats = ("volume", "error", "absolute_error", "squared_error", "percent_diff")
    out = {pkg: pkg.LabelMapEvaluator("y_pred_eval", curve_params=CURVE_PARAMS,
                                      curve_attribute="age", stats_to_output=stats)(
        _subjects(pkg)) for pkg in (jsp, tsp)}
    _assert_same_result(out[tsp], out[jsp])
    plain = {pkg: pkg.LabelMapEvaluator("y_pred_eval")(_subjects(pkg)) for pkg in (jsp, tsp)}
    _assert_same_result(plain[tsp], plain[jsp])
    with pytest.raises(ValueError):
        tsp.LabelMapEvaluator("y", stats_to_output=("error",))


def test_labeled_tensor_and_table_conversions_match_jax():
    out = {}
    for pkg in (jsp, tsp):
        lt = pkg.LabeledTensor(["subject", "label", "stat"],
                               [["a", "b"], ["x", "y"], ["dice", "TP"]])
        lt.data[...] = np.arange(8.0).reshape(2, 2, 2)
        lt["a", "y", "dice"] = np.nan
        out[pkg] = lt
    _assert_equal_nested(out[tsp].to_dict(), out[jsp].to_dict())
    pd.testing.assert_frame_equal(out[tsp].to_dataframe(), out[jsp].to_dataframe())
    np.testing.assert_array_equal(out[tsp]["a", :, "TP"], out[jsp]["a", :, "TP"])
    table = out[tsp].to_table()
    assert len(table) == 4 and list(table.columns) == ["subject", "label", "dice", "TP"]
    np.testing.assert_array_equal(table["TP"], out[jsp].to_dataframe()["TP"].to_numpy())
    row = table.records()[1]
    assert (row["subject"], row["label"], row["TP"]) == ("a", "y", 3.0) and np.isnan(row["dice"])
    summary = {pkg: out[pkg].compute_summary_stats(("mean", "median", "mode", "std", "min",
                                                    "max")) for pkg in (jsp, tsp)}
    np.testing.assert_array_equal(summary[tsp].data, summary[jsp].data)


def test_make_grid_matches_jax():
    rng = np.random.default_rng(2)
    slices = [rng.normal(size=(5 + i, 7 - i)).astype(np.float32) for i in range(5)]
    for ncol in (1, 2, 5, 9):
        np.testing.assert_array_equal(tcontour.make_grid(slices, ncol, pad_value=-1),
                                      jcontour.make_grid(slices, ncol, pad_value=-1))


CONTOURS = {
    # dmri_hippo's montages (main_config.py build_evaluation_schedule)
    "hippo-axial": dict(plane="Axial", slice_id=6, legend=True, ncol=2, split_subjects=False),
    "hippo-coronal": dict(plane="Coronal", slice_id=44, legend=True, ncol=5,
                          split_subjects=False),
    # msseg2's (msseg2.py): a random plane, and the plane with the most label
    "msseg2-random": dict(plane="random", slice_id=0, legend=True, ncol=2,
                          interesting_slice=True, split_subjects=False),
    "msseg2-interesting": dict(plane="interesting", slice_id=0, legend=True, ncol=1,
                               interesting_slice=True, split_subjects=True),
}


@pytest.mark.parametrize("name", list(CONTOURS))
def test_contour_images_match_jax(name):
    """The slice each subject shows, and the rendered montage pixel for pixel
    (Python's random seeded alike for the random plane)."""
    kwargs = CONTOURS[name]
    out = {}
    for pkg, module in ((jsp, jcontour), (tsp, tcontour)):
        evaluator = module.ContourImageEvaluator(
            image_name="mean_dwi", prediction_label_map_name="y_pred_eval",
            target_label_map_name="y_eval", **kwargs)
        subjects = _subjects(pkg)
        slices = [evaluator._get_slice_id(s, kwargs["plane"] if kwargs["plane"] != "random"
                                          else "Axial") for s in subjects]
        random.seed(4)
        images = evaluator(subjects)
        if not kwargs["split_subjects"]:
            images = {"all": images}
        out[pkg] = slices, {k: np.asarray(v) for k, v in images.items()}
    assert out[tsp][0] == out[jsp][0]
    assert out[tsp][1].keys() == out[jsp][1].keys()
    for key, image in out[jsp][1].items():
        assert image.ndim == 3 and image.size > 0
        np.testing.assert_array_equal(out[tsp][1][key], image, err_msg=key)
