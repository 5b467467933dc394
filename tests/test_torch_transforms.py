"""The port's host transforms, their tape and its inversion against the JAX
package's, on the same seeded numpy subjects: every ported transform with
its recorded args, the dmri_hippo ``default`` pipeline, the inversion back to
the original grid and ``add_evaluation_labels``. All host numpy on both
sides, so everything is held equal exactly."""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from research.dmri_hippo.configs.main_config import build_transforms
from segmentation_pipeline_torch.research.dmri_hippo.configs.main_config import \
    build_transforms as port_transforms

MODULES = ("core.subject", "transforms.base", "transforms.spatial", "transforms.intensity",
           "transforms.label", "transforms.structural", "prediction")


def _namespace(root):
    out = SimpleNamespace()
    for name in MODULES:
        module = importlib.import_module(f"{root}.{name}")
        out.__dict__.update({k: v for k, v in vars(module).items() if not k.startswith("__")})
    return out


JAX = _namespace("segmentation_pipeline_tpu")
PORT = _namespace("segmentation_pipeline_torch")
GRID = (20, 18, 6)
CROP = (16, 16, 8)


def _raw(pkg, seed=0, sign=-1.0):
    volumes, affine = chip_smoke.hippo_volumes(np.random.default_rng(seed), GRID)
    affine[0, 0] *= -sign
    return chip_smoke.hippo_subject(pkg, volumes, affine, f"sub-{seed}")


def _assert_subjects_equal(js, ts):
    assert list(js.keys()) == list(ts.keys())
    for key, jv in js.items():
        tv = ts[key]
        if isinstance(jv, JAX.Image):
            assert type(tv).__name__ == type(jv).__name__, key
            assert tv.data.dtype == jv.data.dtype, key
            np.testing.assert_array_equal(tv.data, jv.data, err_msg=key)
            np.testing.assert_array_equal(tv.affine, jv.affine, err_msg=key)
            assert tv.metadata == jv.metadata, key
        else:
            assert tv == jv, key


def _assert_tapes_equal(j_records, t_records):
    assert [type(r.transform).__name__ for r in t_records] == \
        [type(r.transform).__name__ for r in j_records]
    assert [r.args for r in t_records] == [r.args for r in j_records]


def _both(build, subject=_raw, record=True):
    """Apply ``build(pkg)`` to ``subject(pkg)`` in each package."""
    out = []
    for pkg in (JAX, PORT):
        s = subject(pkg)
        build(pkg)(s, record=record)
        out.append(s)
    _assert_subjects_equal(*out)
    _assert_tapes_equal(out[0].history, out[1].history)
    return out


def _invert_both(subjects):
    """Each package's Subject.apply_inverse_transform, held equal."""
    inverted = [s.apply_inverse_transform(warn=False) for s in subjects]
    _assert_subjects_equal(*inverted)
    assert inverted[1].history == []
    return inverted


def test_replace_nan():
    js, ts = _both(lambda pkg: pkg.ReplaceNan(replace_val=-3.0))
    assert not np.isnan(ts["md"].data).any()


@pytest.mark.parametrize("out_min_max,percentiles", [
    ((0.0, 1.0), (0.0, 100.0)), ((-1.0, 1.0), (0.5, 99.5)), ((0.0, 1.0), (0.01, 99.9))])
def test_rescale_intensity(out_min_max, percentiles):
    _both(lambda pkg: pkg.Compose([pkg.ReplaceNan(),
                                   pkg.RescaleIntensity(out_min_max, percentiles)]))


@pytest.mark.parametrize("bounds", [1, (1, 2, 0), (0, 3, 1, 0, 2, 1)])
def test_crop_and_its_inverse(bounds):
    subjects = _both(lambda pkg: pkg.Crop(bounds))
    assert subjects[1].spatial_shape != GRID
    for s in _invert_both(subjects):
        assert s.spatial_shape == GRID


@pytest.mark.parametrize("mode", [0, 2.5, "minimum", "mean", "maximum", "otsu", "edge"])
def test_pad_and_its_inverse(mode):
    subjects = _both(lambda pkg: pkg.Compose([pkg.ReplaceNan(),
                                              pkg.Pad((2, 1, 0, 3, 1, 1), padding_mode=mode)]))
    assert subjects[1].spatial_shape == (23, 21, 8)
    for s in _invert_both(subjects):
        assert s.spatial_shape == GRID


@pytest.mark.parametrize("target,mask_name", [
    (CROP, "whole_roi_union"), (CROP, None), ((24, 12, 6), "whole_roi_union"),
    ((9, 19, 5), "whole_roi")])
def test_crop_or_pad_records_bounds_and_inverts(target, mask_name):
    subjects = _both(lambda pkg: pkg.Compose([
        pkg.ReplaceNan(), pkg.CropOrPad(target, padding_mode="minimum", mask_name=mask_name)]))
    assert subjects[1].spatial_shape == target
    assert set(subjects[1].history[-1].args) == {"crop", "pad"}
    for s in _invert_both(subjects):
        assert s.spatial_shape == GRID


def test_crop_or_pad_inverse_keeps_the_selection():
    subjects = _both(lambda pkg: pkg.CropOrPad(CROP, include=["md", "whole_roi"]))
    inverses = [s.history[0].transform.inverse(s.history[0].args) for s in subjects]
    assert [type(t).__name__ for t in inverses] == ["_UndoCropOrPad"] * 2
    assert inverses[1].include == inverses[0].include == ["md", "whole_roi"]
    _invert_both(subjects)


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("method", [None, "Left", "Right", "whole_roi_union", "callable"])
def test_masking_method(method, sign):
    masks = []
    for pkg in (JAX, PORT):
        s = _raw(pkg, sign=sign)
        m = (lambda subject, data: data > 1.0) if method == "callable" else method
        masks.append(pkg.get_mask_from_masking_method(m, s, s["mean_dwi"].data))
    assert masks[1].dtype == bool and masks[1].shape == (1, *GRID)
    np.testing.assert_array_equal(*masks)


@pytest.mark.parametrize("remapping,masking_method", [
    ({1: 3, 2: 1}, None), ([("right_whole", 2, 1)], "Right"), ([("left_whole", 1, 2)], "Left"),
    ({2: 0}, "whole_roi_union")])
def test_custom_remap_labels_and_its_inverse(remapping, masking_method):
    subjects = _both(lambda pkg: pkg.CustomRemapLabels(remapping, masking_method=masking_method,
                                                       include=["whole_roi"]))
    _invert_both(subjects)


def test_label_transforms_leave_scalar_images_alone():
    js, ts = _both(lambda pkg: pkg.CustomRemapLabels({1: 5}))
    np.testing.assert_array_equal(ts["md"].data, _raw(PORT)["md"].data)
    assert (ts["whole_roi_union"].data == 5).any()


@pytest.mark.parametrize("num_classes", [-1, 4, 0])
def test_one_hot_and_arg_max(num_classes):
    subjects = _both(lambda pkg: pkg.CustomOneHot(num_classes, include=["whole_roi"]))
    assert subjects[1]["whole_roi"].data.shape[0] == {-1: 3, 4: 4, 0: 3}[num_classes]
    for s in _invert_both(subjects):
        assert s["whole_roi"].data.shape == (1, *GRID) and s["whole_roi"]["one_hot"] is False
    js, ts = _both(lambda pkg: pkg.CustomArgMax(include=["whole_roi"]), subject=_scores)
    assert ts["whole_roi"].data.shape == (1, *GRID)


def _scores(pkg):
    s = _raw(pkg)
    s["whole_roi"].set_data(np.random.default_rng(3).uniform(size=(3, *GRID)).astype(np.float32))
    return s


def test_structural_transforms_and_their_inverses():
    def build(pkg):
        return pkg.Compose([
            pkg.ConcatenateImages(list(chip_smoke.INPUT_IMAGES), [1, 1, 1], "X"),
            pkg.CopyProperty("whole_roi", "y_copy"),
            pkg.RenameProperty("whole_roi_union", "mask"),
            pkg.SplitImage("X", ["a", "b"], [2, 1]),
        ])

    subjects = _both(build)
    assert subjects[1]["X"].data.shape == (3, *GRID) and subjects[1]["a"].data.shape[0] == 2
    inverted = _invert_both(subjects)
    assert "whole_roi_union" in inverted[1] and "mask" not in inverted[1]


def test_compose_exclude_and_one_of():
    """A Compose-level exclude reaches its children; OneOf draws from the
    seeded host RNG, the same choices in both packages."""
    def build(pkg):
        pkg.seed_all(7)
        one_of = pkg.OneOf({pkg.Crop(1): 0.3, pkg.Pad(1): 0.7})
        return pkg.Compose([pkg.ReplaceNan(), one_of, one_of, one_of,
                            pkg.RescaleIntensity((-1, 1))], exclude=["fa"])

    js, ts = _both(build)
    assert np.isnan(ts["fa"].data).any()
    assert [type(r.transform).__name__ for r in ts.history][1:4] != ["Crop"] * 3


def test_filter_records_and_filter_transform():
    subjects = _both(lambda pkg: port_transforms(CROP, False)["default"]
                     if pkg is PORT else build_transforms(CROP, False)["default"])
    for types in (["LabelTransform", "CopyProperty", "RenameProperty", "ConcatenateImages"],
                  ["SpatialTransform"], ["IntensityTransform"]):
        kept = [pkg.filter_records(s.history, [getattr(pkg, t) for t in types])
                for pkg, s in zip((JAX, PORT), subjects)]
        _assert_tapes_equal(*kept)
        assert kept[1]
    for pkg in (JAX, PORT):
        pkg.seed_all(1)
    pipelines = [pkg.filter_transform(
        pkg.Compose([pkg.ReplaceNan(), pkg.OneOf([pkg.Crop(1), pkg.RescaleIntensity()]),
                     pkg.Compose([pkg.Pad(1)])]), exclude_types=[pkg.SpatialTransform])
        for pkg in (JAX, PORT)]
    _both(lambda pkg: pipelines[pkg is PORT])


def test_default_pipeline_matches_the_config():
    """The ported configuration's ``default`` transforms against
    main_config's ``default``: X bit for bit, the tape with its args."""
    js, ts = _both(lambda pkg: port_transforms(CROP, False)["default"]
                   if pkg is PORT else build_transforms(CROP, False)["default"])
    assert ts["X"].data.shape == (3, *CROP) and ts["X"].data.dtype == np.float32
    assert ts["y"].data.shape == (2, *CROP)
    assert len(ts.history) == 8


def _predicted(pkg, seed):
    """The subject through the default pipeline, with a one-hot crop-space
    prediction attached as StandardPredict attaches it."""
    s = _raw(pkg, seed)
    (port_transforms(CROP, False)["default"] if pkg is PORT
     else build_transforms(CROP, False)["default"])(s)
    ids = np.random.default_rng(seed + 10).integers(0, 2, CROP)
    y_pred = np.moveaxis(np.eye(2, dtype=np.float32)[ids], -1, 0)
    return pkg._attach_prediction(s, y_pred, None)


@pytest.mark.parametrize("seed", [0, 1])
def test_inversion_back_to_the_original_grid(seed):
    """hippo_inference's inversion of y_pred through the subject's tape, and
    Subject.apply_inverse_transform of the whole subject: equal exactly,
    back on the original grid with the original affine."""
    subjects = [_predicted(pkg, seed) for pkg in (JAX, PORT)]
    raw = _raw(PORT, seed)
    outs = []
    for pkg, s in zip((JAX, PORT), subjects):
        pred = pkg.Subject({"y": s["y_pred"]})
        outs.append(pkg.invert_records(pred, s.get_composed_history(), warn=False))
    _assert_subjects_equal(*outs)
    y = outs[1]["whole_roi"]
    assert y.data.shape == (1, *GRID) and y.data.dtype == np.int32
    np.testing.assert_array_equal(y.affine, raw["mean_dwi"].affine)
    assert set(np.unique(y.data)) <= {0, 1, 2} and (y.data == 2).any()
    inverted = _invert_both([_predicted(pkg, seed) for pkg in (JAX, PORT)])
    np.testing.assert_array_equal(inverted[1]["whole_roi"].data, raw["whole_roi"].data)
    for name in chip_smoke.INPUT_IMAGES:
        assert inverted[1][name].spatial_shape == GRID


def test_apply_inverse_on_new_subject_and_add_evaluation_labels():
    subjects = [_predicted(pkg, 2) for pkg in (JAX, PORT)]
    outs = []
    for pkg, s in zip((JAX, PORT), subjects):
        new = pkg.Subject({"y": s["y"]})
        outs.append(pkg.apply_inverse_on_new_subject(
            s.get_composed_history(), new, include_types=list(pkg.EVAL_LABEL_TYPES)))
    _assert_subjects_equal(*outs)
    assert outs[1]["whole_roi"].data.shape == (1, *CROP)
    # the whole tape, unfiltered: back to the original grid
    whole = [pkg.apply_inverse_on_new_subject(s.get_composed_history(),
                                              pkg.Subject({"y": s["y_pred"]}))
             for pkg, s in zip((JAX, PORT), [_predicted(pkg, 2) for pkg in (JAX, PORT)])]
    _assert_subjects_equal(*whole)
    assert whole[1]["whole_roi"].data.shape == (1, *GRID)
    for pkg, s in zip((JAX, PORT), subjects):
        pkg.add_evaluation_labels([s])
    _assert_subjects_equal(*subjects)
    assert subjects[1]["y_pred_eval"].data.shape == subjects[1]["y_eval"].data.shape == (1, *CROP)
