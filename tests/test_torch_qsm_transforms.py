"""The host transforms that qsm's configuration and dmri_hippo's DWI
augmentation modes add to the port, against the JAX package's on the same
seeded numpy subjects: CustomRemoveLabels, CustomSequentialLabels,
MergeLabels, ZNormalization, Resample's image-name target, scalars_only and
pre_affine_name, TargetResample's spacing statistics, ImageFromLabels'
modes, ReconstructMeanDWI and ReconstructMeanDWIClassic. All host numpy on
both sides, the random ones drawing from each package's host RNG seeded
alike, so everything is held equal exactly (data, affines, metadata and the
recorded args)."""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from segmentation_pipeline_torch.research.qsm_deep_grey_matter.qsm_deep_grey_matter import \
    DGM_LABEL_VALUES

MODULES = ("core.subject", "transforms.base", "transforms.spatial", "transforms.intensity",
           "transforms.label", "transforms.misc", "transforms.dwi")
GRID = (12, 10, 6)
# b = 0, 500 and 1000 s/mm^2: the default b-value range (1e-5, 501) keeps the 500 shell
BVALS = (0.0,) * 2 + (500.0,) * 8 + (1000.0,) * 6


def _namespace(root):
    out = SimpleNamespace()
    for name in MODULES:
        module = importlib.import_module(f"{root}.{name}")
        out.__dict__.update({k: v for k, v in vars(module).items() if not k.startswith("__")})
    return out


JAX = _namespace("segmentation_pipeline_tpu")
PORT = _namespace("segmentation_pipeline_torch")


def _gradient_table(rng):
    bvecs = rng.normal(size=(len(BVALS), 3))
    bvecs /= np.linalg.norm(bvecs, axis=1, keepdims=True)
    return np.concatenate([bvecs, np.asarray(BVALS)[:, None]], axis=1)


def _subject(pkg, seed=0, sign=1.0, mean_dwi=True):
    """A qsm-like subject (t1, qsm, the 17-structure dgm label map, its
    left/right halves by the first affine's x axis) with a DWI series and
    its gradient table."""
    rng = np.random.default_rng(seed)
    affine = np.diag([sign * 1.5, 1.0, 2.0, 1.0])
    affine[:3, 3] = (3.0, -2.0, 1.0)
    values = list(DGM_LABEL_VALUES.values())
    dgm = rng.choice([0] + values, size=(1, *GRID)).astype(np.int16)
    s = pkg.Subject(name=f"sub-{seed}")
    s["t1"] = pkg.ScalarImage(tensor=rng.normal(size=(1, *GRID)).astype(np.float32),
                              affine=affine.copy())
    s["qsm"] = pkg.ScalarImage(tensor=rng.normal(2.0, 3.0, (1, *GRID)).astype(np.float32),
                               affine=affine.copy())
    s["dgm"] = pkg.LabelMap(tensor=dgm, affine=affine.copy(),
                            label_values=dict(DGM_LABEL_VALUES))
    s["ic"] = pkg.LabelMap(tensor=(rng.random((1, *GRID)) < 0.3).astype(np.int16),
                           affine=affine.copy())
    s["full_dwi"] = pkg.ScalarImage(
        tensor=rng.gamma(2.0, 1.0, (len(BVALS), *GRID)).astype(np.float32),
        affine=affine.copy(), grad=_gradient_table(rng))
    if mean_dwi:
        s["mean_dwi"] = pkg.ScalarImage(tensor=np.zeros((1, *GRID), np.float32),
                                        affine=affine.copy())
    return s


def _small(pkg, seed=0, sign=1.0):
    """The subject with one more image on a coarser, shifted grid, for a
    Resample whose target is an image name."""
    s = _subject(pkg, seed, sign)
    affine = np.diag([sign * 3.0, 2.0, 3.0, 1.0])
    affine[:3, 3] = (4.0, -1.0, 2.0)
    s["grid"] = pkg.LabelMap(tensor=np.zeros((1, 6, 5, 4), np.int16), affine=affine)
    return s


def _assert_subjects_equal(js, ts):
    """Images equal exactly (data, dtype, affine, metadata, arrays in the
    metadata too), and every other entry."""
    assert list(js.keys()) == list(ts.keys())
    for key, jv in js.items():
        tv = ts[key]
        if not isinstance(jv, JAX.Image):
            assert tv == jv, key
            continue
        assert type(tv).__name__ == type(jv).__name__, key
        assert tv.data.dtype == jv.data.dtype, key
        np.testing.assert_array_equal(tv.data, jv.data, err_msg=key)
        np.testing.assert_array_equal(tv.affine, jv.affine, err_msg=key)
        assert list(tv.metadata) == list(jv.metadata), key
        for name, value in jv.metadata.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(tv.metadata[name], value, err_msg=key)
            else:
                assert tv.metadata[name] == value, (key, name)


def _assert_same(a, b, where="args"):
    """Recorded args equal exactly, arrays inside them too."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(b, a, err_msg=where)
    else:
        assert a == b, where


def _assert_tapes_equal(j_records, t_records):
    assert [type(r.transform).__name__ for r in t_records] == \
        [type(r.transform).__name__ for r in j_records]
    for j, t in zip(j_records, t_records):
        _assert_same(j.args, t.args)


def _both(build, subject=_subject, seed=0, **subject_kwargs):
    out = []
    for pkg in (JAX, PORT):
        s = subject(pkg, **subject_kwargs)
        pkg.seed_all(seed)
        build(pkg)(s)
        out.append(s)
    _assert_subjects_equal(*out)
    _assert_tapes_equal(out[0].history, out[1].history)
    return out


REMOVED = ["left_ventricle", "right_ventricle", "left_dentate_nucleus", "right_dentate_nucleus"]
MERGED = [("left_caudate", "right_caudate"), ("left_putamen", "right_putamen"),
          ("left_globus_pallidus", "right_globus_pallidus"),
          ("left_substantia_nigra", "right_substantia_nigra")]

CASES = {
    "CustomRemoveLabels by name and id": lambda p: p.CustomRemoveLabels(
        labels=REMOVED + [17], include=["dgm"]),
    "CustomRemoveLabels masked": lambda p: p.CustomRemoveLabels(
        labels=["left_thalamus", 19], background_label=2, masking_method="Left",
        include=["dgm"]),
    "CustomRemoveLabels by mask image": lambda p: p.CustomRemoveLabels(
        labels=["internal_capsule"], masking_method="ic", include=["dgm"]),
    "CustomSequentialLabels": lambda p: p.CustomSequentialLabels(include=["dgm"]),
    "CustomSequentialLabels without label_values": lambda p: p.CustomSequentialLabels(
        include=["ic"]),
    "MergeLabels right": lambda p: p.MergeLabels(MERGED, right_masking_method="Right",
                                                 include=["dgm"]),
    "MergeLabels left": lambda p: p.MergeLabels(MERGED, left_masking_method="Left",
                                                include=["dgm"]),
    # qsm's default pipeline's label chain: two names share an id after the
    # merge, and the sequential ids rank the values (10 classes)
    "qsm label chain": lambda p: p.Compose([
        p.CustomRemoveLabels(labels=REMOVED, include=["dgm"]),
        p.MergeLabels(MERGED, right_masking_method="Right", include=["dgm"]),
        p.CustomSequentialLabels(include=["dgm"])]),
    "ZNormalization": lambda p: p.ZNormalization(),
    "ZNormalization masked by a label map": lambda p: p.ZNormalization(
        masking_method="ic", include=["t1", "qsm"]),
    "ZNormalization masked by a half": lambda p: p.ZNormalization(masking_method="Right"),
    "ImageFromLabels overwrite": lambda p: p.ImageFromLabels(
        "weights", [("ic", 1, 0.5), ("dgm", "left_caudate", 2.0), ("dgm", 17, 4.0)]),
    "ImageFromLabels additive": lambda p: p.ImageFromLabels(
        "weights", [("ic", 1, 0.5), ("dgm", "left_caudate", 2.0), ("dgm", 17, 4.0)],
        mode="additive"),
    "Resample scalars_only": lambda p: p.Resample(2.0, scalars_only=True,
                                                  exclude=["full_dwi"]),
    "TargetResample median, pre_affine_name": lambda p: p.TargetResample(
        "median", 0.1, pre_affine_name="t1", exclude=["full_dwi"]),
    "TargetResample max, scalars_only, bspline": lambda p: p.TargetResample(
        "max", (0.1, 0.1, 0.2), image_interpolation="bspline", scalars_only=True,
        include=["t1", "dgm"]),
    "ReconstructMeanDWI": lambda p: p.ReconstructMeanDWI(),
    "ReconstructMeanDWI ranges": lambda p: p.ReconstructMeanDWI(
        num_dwis=(1, 7), num_directions=(1, 3), directionality=(4, 10)),
    "ReconstructMeanDWI other shell": lambda p: p.ReconstructMeanDWI(
        num_dwis=3, bval_range=(600.0, 1100.0), mean_dwi_image_name="mean_b1000"),
    "ReconstructMeanDWIClassic": lambda p: p.ReconstructMeanDWIClassic(subset_size=5),
}


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("name", list(CASES))
def test_transform_matches_jax(name, sign):
    jax_s, port_s = _both(CASES[name], sign=sign, seed=3)
    if name == "qsm label chain":
        values = port_s["dgm"]["label_values"]
        assert sorted(set(values.values())) == list(range(1, 10))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resample_to_an_image_grid_matches_jax(seed):
    """Resample(target=<image name>): every image onto that image's grid."""
    jax_s, port_s = _both(lambda p: p.Resample("grid", exclude=["full_dwi"]), subject=_small,
                          seed=seed, sign=(-1.0) ** seed)
    assert port_s["t1"].spatial_shape == (6, 5, 4)
    np.testing.assert_array_equal(port_s["qsm"].affine, port_s["grid"].affine)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cls", ["ReconstructMeanDWI", "ReconstructMeanDWIClassic"])
def test_mean_dwi_is_a_fresh_image_of_the_shell(cls, seed):
    """Without a mean_dwi image the transform adds a fresh one (not a copy
    of the series): the mean of the recorded b=500 volumes, as in JAX."""
    jax_s, port_s = _both(lambda p: getattr(p, cls)(), mean_dwi=False, seed=seed)
    shell = np.asarray(port_s["full_dwi"].data)[np.asarray(BVALS) == 500.0]
    [record] = port_s.history
    expected = shell[record.args["indices"]].mean(axis=0, keepdims=True).astype(np.float32)
    np.testing.assert_array_equal(port_s["mean_dwi"].data, expected)
    assert port_s["mean_dwi"].paths == () or not port_s["mean_dwi"].paths
    assert "grad" not in port_s["mean_dwi"].metadata


def test_merge_labels_takes_exactly_one_mask():
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError, match="Exactly one"):
            pkg.MergeLabels(MERGED)
        with pytest.raises(ValueError, match="Exactly one"):
            pkg.MergeLabels(MERGED, left_masking_method="Left", right_masking_method="Right")
        with pytest.raises(ValueError, match="strings"):
            pkg.MergeLabels([("left_caudate", 4)], right_masking_method="Right")
