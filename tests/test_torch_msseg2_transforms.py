"""The port's msseg2 geometry transforms against the JAX package's, on the
same subjects: SetDataType, resample_array, Resample, TargetResample,
CropToMask and MinSizePad with its inverse."""
import numpy as np
import pytest

import segmentation_pipeline_tpu as jsp
from segmentation_pipeline_tpu.transforms import spatial as jspatial
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch.transforms import spatial as tspatial

GRID = (14, 12, 9)


def _affine(spacing):
    affine = np.diag([-spacing[0], spacing[1], spacing[2], 1.0])
    affine[:3, 3] = [7.0, -5.5, 3.0]
    return affine


def _subject(pkg, spacing=(0.9375, 0.9375, 1.2), mask=True, seed=0):
    rng = np.random.default_rng(seed)
    s = pkg.Subject(name="s0")
    s["flair"] = pkg.ScalarImage(tensor=rng.gamma(2.0, 1.0, (1, *GRID)), affine=_affine(spacing))
    labels = np.zeros((1, *GRID), np.int64)
    if mask:
        labels[0, 3:10, 2:9, 2:7] = 1
        labels[0, 5, 4, 3] = 2
    s["brain_mask"] = pkg.LabelMap(tensor=labels, affine=_affine(spacing),
                                   label_values={"brain": 1})
    return s


def _assert_same(port, ref):
    assert list(port.keys()) == list(ref.keys())
    for name, image in ref.get_images_dict().items():
        assert port[name].data.dtype == image.data.dtype, name
        np.testing.assert_array_equal(port[name].data, image.data)
        np.testing.assert_array_equal(port[name].affine, image.affine)
    assert [type(r.transform).__name__ for r in port.history] == \
        [type(r.transform).__name__ for r in ref.history]
    for a, b in zip(port.history, ref.history):
        assert repr(a.args) == repr(b.args)


def _both(make, **subject_kwargs):
    """The transform ``make(pkg)`` on each package's copy of one subject."""
    return [make(pkg)(_subject(pkg, **subject_kwargs)) for pkg in (tsp, jsp)]


@pytest.mark.parametrize("data_type,intensity_only", [
    (np.float32, True), ("float", False), ("int", True), (np.int16, False)])
def test_set_data_type_matches_jax(data_type, intensity_only):
    _assert_same(*_both(lambda pkg: pkg.SetDataType(data_type, intensity_only=intensity_only)))


@pytest.mark.parametrize("order", [0, 1, 3])
def test_resample_array_matches_jax(order):
    rng = np.random.default_rng(order)
    data = rng.normal(size=(2, *GRID)).astype(np.float32)
    src = _affine((0.9375, 0.9375, 1.2))
    dst = src.copy()
    dst[:3, :3] = np.diag([-1.1, 0.8, 0.9])
    dst[:3, 3] += [0.3, -0.2, 0.7]
    args = (data, src, dst, (12, 15, 11), order)
    out = tspatial.resample_array(*args)
    assert out.dtype == np.float32 and out.shape == (2, 12, 15, 11)
    np.testing.assert_array_equal(out, jspatial.resample_array(*args))


@pytest.mark.parametrize("target,interpolation", [
    (1.0, "linear"), ((0.8, 1.1, 0.7), "linear"), (1.3, "nearest")])
def test_resample_matches_jax(target, interpolation):
    def make(pkg):
        return pkg.Resample(target, image_interpolation=interpolation)
    port, ref = _both(make)
    _assert_same(port, ref)
    assert port["brain_mask"].data.dtype == np.int32


@pytest.mark.parametrize("spacing,target,tolerance", [
    ((0.9375, 0.9375, 1.2), 1, 0.11),          # W, H within tolerance; D snaps to 0.9
    ((0.95, 1.05, 1.02), 1, 0.11),             # everything within: no resample
    ((0.5, 0.55, 0.6), 1, 0.05),               # upscale, snapped
    ((2.5, 1.8, 3.1), (1.0, 1.0, 2.0), 0.2),   # downscale, snapped
    ((0.9, 1.3, 1.1), (1.0, 1.2, 1.0), (0.01, 0.05, 0.2))])   # per-axis tolerance
def test_target_resample_matches_jax(spacing, target, tolerance):
    port, ref = _both(lambda pkg: pkg.TargetResample(target, tolerance), spacing=spacing)
    _assert_same(port, ref)


def test_snap_spacing_matches_jax():
    rng = np.random.default_rng(5)
    for cur, tar, tol in zip(rng.uniform(0.3, 4, 200), rng.uniform(0.3, 4, 200),
                             rng.uniform(0.01, 0.3, 200)):
        assert tsp.TargetResample._snap_spacing(cur, tar, tol) == \
            jsp.TargetResample._snap_spacing(cur, tar, tol)
    assert tsp.TargetResample._snap_spacing(1.2, 1.0, 0.11) == pytest.approx(0.9)


@pytest.mark.parametrize("label_id", [1, 2])
def test_crop_to_mask_matches_jax(label_id):
    _assert_same(*_both(lambda pkg: pkg.CropToMask("brain_mask", label_id=label_id)))


def test_crop_to_mask_empty_or_missing_mask():
    for pkg in (tsp, jsp):
        with pytest.raises(RuntimeError, match="no voxels"):
            pkg.CropToMask("brain_mask")(_subject(pkg, mask=False))
        subject = pkg.CropToMask("absent")(_subject(pkg))
        assert subject["flair"].spatial_shape == GRID


@pytest.mark.parametrize("min_size,padding_mode", [(16, 0), ((9, 15, 12), "edge"), (4, 0)])
def test_min_size_pad_and_its_inverse_match_jax(min_size, padding_mode):
    port, ref = _both(lambda pkg: pkg.MinSizePad(min_size, padding_mode=padding_mode))
    _assert_same(port, ref)
    inverted = [s.apply_inverse_transform(warn=False) for s in (port, ref)]
    _assert_same(*inverted)
    for s, pkg in zip(inverted, (tsp, jsp)):
        original = _subject(pkg)
        np.testing.assert_array_equal(s["flair"].data, original["flair"].data)
        np.testing.assert_array_equal(s["flair"].affine, original["flair"].affine)
    with pytest.raises(KeyError):
        tsp.MinSizePad([16, 16, 16])
