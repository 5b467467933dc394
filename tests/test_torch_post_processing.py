"""The port's post-processing (scipy.ndimage) against the JAX package's, on
label volumes with holes, several components and an equal-size tie at the
keep_components cut-off: equal exactly. The JAX package labels components
with its native library when that has built and with scipy otherwise; the
port must equal both."""
import numpy as np
import pytest
from scipy import ndimage as ndi

import segmentation_pipeline_tpu.native as jnative
from segmentation_pipeline_tpu import post_processing as jpost
from segmentation_pipeline_torch import post_processing as tpost


@pytest.fixture(params=["as built", "scipy"])
def jax_path(request, monkeypatch):
    if request.param == "scipy":
        monkeypatch.setattr(jnative, "_build_and_load", lambda: None)
    return request.param


def tied_volume():
    """Label 1 with holes of 1, 8 and 125 voxels, label 2 beside it, and two
    equal components of 27 voxels behind a larger one: keep_components(img,
    2) keeps label 1's and one of the two, chosen by component numbering."""
    img = np.zeros((24, 20, 12), np.int32)
    img[2:14, 2:16, 1:11] = 1
    img[4, 4, 4] = 0                     # 1-voxel hole
    img[8:10, 4:6, 4:6] = 0              # 8-voxel hole
    img[6:11, 9:14, 3:8] = 0             # 125-voxel hole
    img[14:20, 2:16, 1:11] = 2           # touches label 1: one component
    img[21:24, 2:5, 2:5] = 2             # 27 voxels
    img[21:24, 10:13, 6:9] = 1           # 27 voxels, the tie
    img[22, 17, 10] = 2                  # 1 voxel
    return img


def noisy_volume(seed):
    """Smoothed noise cut into labels 0, 1, 2: many components and holes."""
    noise = ndi.gaussian_filter(np.random.default_rng(seed).normal(size=(20, 18, 10)), 1.0)
    return np.digitize(noise, [0.05, 0.15]).astype(np.int32)


VOLUMES = {"tied": tied_volume, "noise0": lambda: noisy_volume(0),
           "noise1": lambda: noisy_volume(1)}


@pytest.mark.parametrize("name", VOLUMES)
@pytest.mark.parametrize("hole_size", [1, 8, 64])
def test_remove_holes(jax_path, name, hole_size):
    img = VOLUMES[name]()
    out, n = tpost.remove_holes(img, hole_size)
    ref, n_ref = jpost.remove_holes(img, hole_size)
    assert n == n_ref and out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", VOLUMES)
@pytest.mark.parametrize("num", [1, 2, 3])
def test_keep_components(jax_path, name, num):
    img = VOLUMES[name]()
    out = tpost.keep_components(img, num)
    ref = jpost.keep_components(img, num)
    assert out[1:] == ref[1:] and out[0].dtype == ref[0].dtype
    np.testing.assert_array_equal(out[0], ref[0])
    if name == "tied" and num == 2:
        # the descending sort reverses a stable one: of the two equal
        # components the later-numbered (later in raster order) stays
        assert (out[0][21:24, 10:13, 6:9] == 1).all() and out[1] == 2
        assert (out[0][21:24, 2:5, 2:5] == 0).all()


@pytest.mark.parametrize("name", VOLUMES)
def test_remove_small_components(jax_path, name):
    img = VOLUMES[name]()
    out, n = tpost.remove_small_components(img, 30)
    ref, n_ref = jpost.remove_small_components(img, 30)
    assert n == n_ref
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("descending", [False, True])
def test_sort_by_size_and_back(descending):
    img = tied_volume()
    labels = ndi.label(img > 0, structure=np.ones((3, 3, 3)))[0]
    out = tpost.sort_by_size(labels, descending)
    ref = jpost.sort_by_size(labels, descending)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpost.unsort_by_size(out[0], out[1]), labels)
    with pytest.raises(ValueError):
        tpost.unsort_by_size(out[0] + 1, out[1])
