"""The port's random transforms of msseg2's ``training`` pipeline against the
JAX package's, on the same small subject with a LabelMap, each package's
host RNG seeded alike (``seed_all``): PermuteDimensions and
RandomPermuteDimensions, Flip and RandomFlip, Affine and RandomAffine,
ElasticDeformation and RandomElasticDeformation, the inverse displacement
field, RandomNoise, RandomBlur, RandomGamma, RandomBiasField and
ImageFromLabels; the inversions of the tape; the whole ``training``
pipeline on a raw subject."""
import copy

import numpy as np
import pytest

import chip_smoke
import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.msseg2.msseg2 import build_pipelines
from segmentation_pipeline_tpu.transforms import random_spatial as jrandom_spatial
from segmentation_pipeline_tpu.transforms import spatial as jspatial
from segmentation_pipeline_tpu.transforms import structural as jstructural
from segmentation_pipeline_torch.transforms import random_spatial as trandom_spatial
from segmentation_pipeline_torch.transforms import spatial as tspatial
from segmentation_pipeline_torch.transforms import structural as tstructural
from segmentation_pipeline_torch.research.msseg2.msseg2 import build_pipelines as port_pipelines

GRID = (20, 18, 14)
MODULES = {jsp: {"structural": jstructural, "spatial": jspatial,
                 "random_spatial": jrandom_spatial},
           tsp: {"structural": tstructural, "spatial": tspatial,
                 "random_spatial": trandom_spatial}}


def _affine():
    affine = np.diag([-0.9375, 0.9375, 1.2, 1.0])
    affine[:3, 3] = [9.0, -8.5, 4.0]
    return affine


def _subject(pkg, seed=0):
    """Two FLAIRs, a brain mask and a lesion ground truth (both LabelMaps
    with label values) on an anisotropic grid."""
    rng = np.random.default_rng(seed)
    s = pkg.Subject(name="s0")
    for name in chip_smoke.MS_TIMEPOINTS:
        s[name] = pkg.ScalarImage(tensor=rng.gamma(2.0, 1.0, (1, *GRID)).astype(np.float32),
                                  affine=_affine())
    brain = np.zeros((1, *GRID), np.int32)
    brain[0, 3:17, 2:16, 2:12] = 1
    lesion = np.zeros((1, *GRID), np.int32)
    lesion[0, 6:9, 5:8, 4:6] = 1
    lesion[0, 12, 10, 8] = 1
    s["brain_mask"] = pkg.LabelMap(tensor=brain, affine=_affine(), label_values={"brain": 1})
    s["ground_truth"] = pkg.LabelMap(tensor=lesion, affine=_affine(),
                                     label_values={"lesion": 1})
    return s


def _assert_same(port, ref):
    assert list(port.keys()) == list(ref.keys())
    for name, image in ref.get_images_dict().items():
        assert port[name].data.dtype == image.data.dtype, name
        np.testing.assert_array_equal(port[name].data, image.data, err_msg=name)
        np.testing.assert_array_equal(port[name].affine, image.affine, err_msg=name)
    assert [type(r.transform).__name__ for r in port.history] == \
        [type(r.transform).__name__ for r in ref.history]


def _control_grid():
    grid = np.random.default_rng(5).uniform(-3, 3, (3, 5, 5, 5)).astype(np.float32)
    grid[:, :1] = grid[:, -1:] = 0
    return grid


# name -> a transform of a package, given the package and its modules
CASES = {
    "PermuteDimensions": lambda pkg, m: m["structural"].PermuteDimensions((2, 0, 1)),
    "RandomPermuteDimensions": lambda pkg, m: pkg.RandomPermuteDimensions(),
    "Flip": lambda pkg, m: m["spatial"].Flip((0, 2)),
    "RandomFlip": lambda pkg, m: pkg.RandomFlip(axes=(0, 1, 2)),
    "Affine": lambda pkg, m: m["random_spatial"].Affine(
        matrix=np.array([[0.95, 0.1, 0.0], [-0.1, 1.05, 0.05], [0.0, -0.05, 1.0]]),
        translation=(1.5, -2.0, 0.5), default_pad_value="otsu"),
    "RandomAffine": lambda pkg, m: pkg.RandomAffine(scales=0.2, degrees=45,
                                                    default_pad_value="otsu"),
    "ElasticDeformation": lambda pkg, m: m["random_spatial"].ElasticDeformation(
        _control_grid()),
    "RandomElasticDeformation": lambda pkg, m: pkg.RandomElasticDeformation(),
    "RandomNoise": lambda pkg, m: pkg.RandomNoise(std=0.1),
    "RandomBlur": lambda pkg, m: pkg.RandomBlur((0, 1)),
    "RandomGamma": lambda pkg, m: pkg.RandomGamma(),
    "RandomBiasField": lambda pkg, m: pkg.RandomBiasField(),
    "ImageFromLabels": lambda pkg, m: pkg.ImageFromLabels(
        new_image_name="patch_probability",
        label_weights=[("brain_mask", "brain", 1), ("ground_truth", "lesion", 100)]),
    "ImageFromLabels overwritten": lambda pkg, m: pkg.ImageFromLabels(
        new_image_name="patch_probability",
        label_weights=[("ground_truth", "lesion", 2.0), ("brain_mask", 1, 0.5)]),
}
INVERTIBLE = {"PermuteDimensions", "RandomPermuteDimensions", "Flip", "RandomFlip", "Affine",
              "RandomAffine", "ElasticDeformation", "RandomElasticDeformation"}


@pytest.mark.parametrize("name", list(CASES))
def test_transform_matches_jax(name):
    """The same draws (each package seeded alike) give equal arrays and
    affines, and where the transform is invertible the inversions of the
    tapes agree too."""
    out = {}
    for pkg in (jsp, tsp):
        pkg.seed_all(11)
        subject = CASES[name](pkg, MODULES[pkg])(_subject(pkg))
        out[pkg] = subject
    _assert_same(out[tsp], out[jsp])
    if name in INVERTIBLE:
        back = {pkg: pkg.invert_records(copy.deepcopy(s), s.history, warn=True)
                for pkg, s in out.items()}
        _assert_same(back[tsp], back[jsp])


def test_inverse_displacement_field_matches_jax():
    u = trandom_spatial.ElasticDeformation.dense_field(_control_grid(), (24, 22, 20))
    np.testing.assert_array_equal(
        u, jrandom_spatial.ElasticDeformation.dense_field(_control_grid(), (24, 22, 20)))
    np.testing.assert_array_equal(trandom_spatial.invert_displacement_field_voxels(u, tol=1e-4),
                                  jrandom_spatial.invert_displacement_field_voxels(u, tol=1e-4))


@pytest.mark.parametrize("name", ["RandomAffine", "RandomElasticDeformation"])
def test_warp_round_trip_on_a_ramp(name):
    """A linear ramp warped and warped back through the port's tape: linear
    interpolation reproduces a ramp, so the interior returns within 1e-3
    (what the JAX package's own test holds its inversion to)."""
    w, h, d = np.meshgrid(*[np.arange(n) for n in (32, 28, 24)], indexing="ij")
    ramp = (0.5 * w + 0.25 * h - 0.125 * d).astype(np.float32)[None]
    s = tsp.Subject(name="ramp")
    s["img"] = tsp.ScalarImage(tensor=ramp.copy(), affine=np.eye(4))
    tsp.seed_all(6)
    warp = (tsp.RandomAffine(scales=0.08, degrees=8, translation=2) if name == "RandomAffine"
            else tsp.RandomElasticDeformation(num_control_points=5, max_displacement=1.5,
                                              locked_borders=1))
    warp(s)
    assert not np.allclose(s["img"].data, ramp, atol=1e-2)
    tsp.invert_records(s, s.history, warn=True)
    m = 6
    np.testing.assert_allclose(s["img"].data[:, m:-m, m:-m, m:-m],
                               ramp[:, m:-m, m:-m, m:-m], atol=1e-3)


def test_training_pipeline_matches_jax():
    """A raw msseg2 training subject through the port's ``training``
    transforms (the ported configuration's build_pipelines) and JAX's own
    (research/msseg2/msseg2.py build_pipelines), at one seed: X, y, the
    patch-probability map and the tape are equal; and again at another seed,
    which takes other branches of the OneOf and the random transforms."""
    volumes, affine = chip_smoke.msseg2_volumes(np.random.default_rng(3), (40, 36, 30),
                                                chip_smoke.MS_RAW_SPACING, (14.0, 12.0, 11.0))
    for seed in (0, 5):
        out = {}
        for pkg, pipeline in ((jsp, build_pipelines(32)["training"]),
                              (tsp, port_pipelines(32)["training"])):
            pkg.seed_all(seed)
            raw = chip_smoke.msseg2_subject(pkg, volumes, affine, "sub-0", ground_truth=True)
            out[pkg] = pipeline(raw)
        _assert_same(out[tsp], out[jsp])
        s = out[tsp]
        assert s["X"].data.shape[0] == 2 and s["y"].data.shape[0] == 2
        assert s["y"]["one_hot"] and s["y"].data[1].sum() > 0
        assert set(np.unique(s["patch_probability"].data)) <= {0.0, 1.0, 100.0}
