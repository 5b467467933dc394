"""The port's data ingestion against the JAX package's, on one folder in
dmri_hippo's layout written into ``tmp_path`` by the port's NIfTI codec and
read by both packages' SubjectFolder with dmri_hippo's loaders, cohorts and
transforms (research/dmri_hippo/configs/main_config.py and its port): the
subjects' names, attributes and images, every filter class's selection,
the transformed subjects of the ``default`` and ``training`` pipelines with
their tapes and inversions, CopyAffine and ``ref_img``,
``load_additional_data``, the CSV and tensor loaders and
``prepare_dataset_files`` on a folder and on a tar. Host numpy on both
sides, so everything is held equal exactly."""
import copy
import json
import tarfile

import numpy as np
import pytest

import chip_smoke
import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.dmri_hippo.configs import main_config as jconfig
from segmentation_pipeline_tpu.utils.dataset_files import prepare_dataset_files as jprepare
from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config as tconfig
from segmentation_pipeline_torch.utils.dataset_files import prepare_dataset_files as tprepare
from test_torch_transforms import _assert_subjects_equal, _assert_tapes_equal

GRID = (20, 18, 6)
CROP = (16, 16, 8)
N_SUBJECTS = 9
CONFIGS = {jsp: jconfig, tsp: tconfig}


def write_hippo_dataset(root, n=N_SUBJECTS, grid=GRID, seed=0):
    """dmri_hippo's layout: subjects/<name>/{mean_dwi,md,fa,whole_roi}.nii.gz
    and attributes.json, the atlas mask, and the dataset-level attribute
    files. Subjects 0..n-3 are cbbrain with folds, the last two ab300 with
    ages; the fa of subject 1 carries another affine than its mean_dwi."""
    rng = np.random.default_rng(seed)
    split, ab300, test = {}, {}, {}
    for i in range(n):
        name = f"cbbrain_{i:03d}" if i < n - 2 else f"ab300_{i:03d}"
        folder = root / "subjects" / name
        folder.mkdir(parents=True)
        volumes, affine = chip_smoke.hippo_volumes(rng, grid)
        for key in (*chip_smoke.INPUT_IMAGES, "whole_roi"):
            shifted = affine.copy()
            if key == "fa" and i == 1:
                shifted[:3, 3] += 0.5
            tsp.write_nifti(folder / f"{key}.nii.gz", volumes[key], shifted)
        if i == 0:
            (root / "atlas").mkdir()
            tsp.write_nifti(root / "atlas" / "whole_roi_union.nii.gz",
                            volumes["whole_roi_union"], affine)
        attributes = {"protocol": "cbbrain" if i < n - 2 else "ab300",
                      "age": float(20 + 3 * i), "rescan_id": "None" if i % 3 else f"r{i}"}
        with open(folder / "attributes.json", "w") as f:
            json.dump(attributes, f)
        if i < n - 2:
            split[name] = {"fold": i % 3}
            if i == n - 3:
                test[name] = {"cbbrain_test": True}
        else:
            ab300[name] = {"ab300_validation": True}
    (root / "attributes").mkdir()
    for file_name, data in (("cross_validation_split", split),
                            ("ab300_validation_subjects", ab300),
                            ("cbbrain_test_subjects", test)):
        with open(root / "attributes" / f"{file_name}.json", "w") as f:
            json.dump(data, f)


def folder(pkg, root, fold=0):
    config = CONFIGS[pkg]
    return pkg.SubjectFolder(str(root), "subjects", config.build_subject_loader(),
                             cohorts=config.build_cohorts(fold),
                             transforms=config.build_transforms(CROP, False), ref_img="mean_dwi")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("hippo")
    write_hippo_dataset(root)
    return root, {pkg: folder(pkg, root) for pkg in (jsp, tsp)}


def _names(subjects):
    return [s["name"] for s in subjects]


def test_subjects_attributes_and_images_match_jax(dataset):
    _, folders = dataset
    j, t = folders[jsp], folders[tsp]
    assert _names(t.all_subjects) == _names(j.all_subjects)
    assert len(t.all_subjects) == N_SUBJECTS
    for js, ts in zip(j.all_subjects, t.all_subjects):
        assert list(ts.keys()) == list(js.keys())
        for key, value in js.items():
            if isinstance(value, jsp.Image):
                np.testing.assert_array_equal(ts[key].data, value.data, err_msg=key)
                np.testing.assert_array_equal(ts[key].affine, value.affine, err_msg=key)
                assert ts[key].metadata == value.metadata, key
            elif key != "folder":
                assert ts[key] == value, key


def test_ref_img_and_copy_affine_match_jax(dataset):
    """SubjectFolder's ref_img runs CopyAffine off the tape at scan time, on
    images not loaded yet; loading then reads each file's own affine, in
    both packages alike. CopyAffine on a loaded subject gives every image
    the mean_dwi's affine."""
    _, folders = dataset
    out = {}
    for pkg in (jsp, tsp):
        s = folders[pkg].all_subjects_map["cbbrain_001"]
        assert s.history == []
        loaded = copy.deepcopy(s)
        loaded.load()
        copied = pkg.CopyAffine("mean_dwi")(copy.deepcopy(loaded), record=False)
        out[pkg] = [(img.affine, copied[name].affine)
                    for name, img in loaded.get_images_dict().items()]
        for _, affine in out[pkg]:
            np.testing.assert_array_equal(affine, copied["mean_dwi"].affine)
    for (ja, jc), (ta, tc) in zip(out[jsp], out[tsp]):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tc, jc)


def test_config_cohorts_match_jax(dataset):
    """Every cohort of dmri_hippo's config (RandomSelectFilter included)
    selects the same subjects."""
    _, folders = dataset
    cohorts = list(tconfig.build_cohorts(0))
    assert cohorts == list(jconfig.build_cohorts(0))
    for name in cohorts:
        selected = {pkg: _names(f.get_cohort_dataset(name).subjects)
                    for pkg, f in folders.items()}
        assert selected[tsp] == selected[jsp], name
    assert len(folders[tsp].get_cohort_dataset("training").subjects) == 4


FILTERS = {
    "RequireAttributes-list": lambda pkg: pkg.RequireAttributes(["age", "fold"]),
    "RequireAttributes-dict": lambda pkg: pkg.RequireAttributes({"fold": [0, 2]}),
    "ForbidAttributes-list": lambda pkg: pkg.ForbidAttributes(["fold"]),
    "ForbidAttributes-dict": lambda pkg: pkg.ForbidAttributes({"protocol": "ab300"}),
    "ComposeFilters": lambda pkg: pkg.ComposeFilters(
        pkg.RequireAttributes(["fold"]), pkg.ForbidAttributes({"fold": 1})),
    "AnyFilter": lambda pkg: pkg.AnyFilter([pkg.RequireAttributes({"fold": 1}),
                                            pkg.RequireAttributes({"protocol": "ab300"})]),
    "NegateFilter": lambda pkg: pkg.NegateFilter(pkg.RequireAttributes({"fold": 2})),
    "subtract": lambda pkg: pkg.RequireAttributes(["age"]) - pkg.RequireAttributes({"fold": 0}),
    "RandomSelectFilter": lambda pkg: pkg.RandomSelectFilter(num_subjects=4, seed=7),
    "RandomFoldFilter": lambda pkg: pkg.RandomFoldFilter(num_folds=4, selection=[1, 3],
                                                         seed=0xDEADBEEF),
    "StratifiedFilter": lambda pkg: pkg.StratifiedFilter(
        size=4, continuous_attributes=["age"], discrete_attributes=["protocol"],
        n_continuous_bins=2, seed=3),
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_filters_match_jax(dataset, name):
    """Each filter class on fresh copies of the subjects (RandomFoldFilter
    writes 'fold' into subjects that have none)."""
    root, _ = dataset
    out = {}
    for pkg in (jsp, tsp):
        subjects = [s for s in folder(pkg, root).all_subjects]
        if name == "RandomFoldFilter":
            for s in subjects:
                s.pop("fold", None)
        selected = FILTERS[name](pkg)(subjects)
        out[pkg] = (_names(selected), [s.get("fold") for s in subjects])
    assert out[tsp] == out[jsp]
    assert 0 < len(out[tsp][0]) < N_SUBJECTS


@pytest.mark.parametrize("pipeline", ["default", "training"])
def test_transformed_subjects_match_jax(dataset, pipeline):
    """Item access: the cohort's pipeline on a deep copy, equal with its
    tape; the stored subject stays raw. The ``training`` pipeline draws its
    random transforms from each package's host RNG, seeded alike."""
    _, folders = dataset
    cohort = "training" if pipeline == "training" else "cbbrain_validation"
    out = {}
    for pkg in (jsp, tsp):
        ds = folders[pkg].get_cohort_dataset(cohort)
        pkg.seed_all(5)
        out[pkg] = [ds[i] for i in range(len(ds))]
        assert ds.subjects[0].history == []
    for js, ts in zip(out[jsp], out[tsp]):
        _assert_subjects_equal(js, ts)
        _assert_tapes_equal(js.history, ts.history)
        assert ts["X"].data.shape == (3, *CROP)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_training_pipeline_and_its_inversion_match_jax(dataset, seed):
    """dmri_hippo's ``training`` transforms (main_config.py:145-158: the
    bspline elastic warp on a (7, 7, 4) grid, exclude=["full_dwi"], the
    OneOf of blur and noise) at several seeds, and the inversion of the
    whole tape back to the scanner grid."""
    _, folders = dataset
    out = {}
    for pkg in (jsp, tsp):
        raw = folders[pkg].all_subjects_map["cbbrain_004"]
        pipeline = CONFIGS[pkg].build_transforms(CROP, False)["training"]
        pkg.seed_all(seed)
        out[pkg] = pipeline(copy.deepcopy(raw))
    _assert_subjects_equal(out[jsp], out[tsp])
    _assert_tapes_equal(out[jsp].history, out[tsp].history)
    inverted = [out[pkg].apply_inverse_transform(warn=False) for pkg in (jsp, tsp)]
    _assert_subjects_equal(*inverted)
    assert inverted[1]["whole_roi"].spatial_shape == GRID


def test_preloading_matches_item_access(dataset):
    """preload_subjects and preload_and_transform_subjects give the subjects
    item access gives, with the same transforms."""
    root, folders = dataset
    ds = folders[tsp].get_cohort_dataset("cbbrain_validation")
    expected = [ds[i] for i in range(len(ds))]
    ds.preload_subjects()
    assert all(img.loaded for s in ds.subjects for img in s.get_images_dict().values())
    ds.preload_and_transform_subjects()
    for e, s in zip(expected, [ds[i] for i in range(len(ds))]):
        assert list(s.keys()) == list(e.keys())
        for name, image in e.get_images_dict().items():
            np.testing.assert_array_equal(s[name].data, image.data, err_msg=name)
            np.testing.assert_array_equal(s[name].affine, image.affine, err_msg=name)
        _assert_tapes_equal(e.history, s.history)


def test_load_additional_data_matches_jax(dataset, tmp_path):
    """Saved predictions attached to matching subjects in place
    (research/dmri_hippo/evaluate.py's path)."""
    root, _ = dataset
    rng = np.random.default_rng(3)
    for name in ("cbbrain_000", "cbbrain_002", "nobody"):
        (tmp_path / name).mkdir()
        tsp.write_nifti(tmp_path / name / "pred.nii.gz",
                        rng.integers(0, 3, (1, *GRID)).astype(np.int32), np.eye(4))
    out = {}
    for pkg in (jsp, tsp):
        ds = folder(pkg, root)
        ds.load_additional_data(str(tmp_path), pkg.ImageLoader(
            glob_pattern="pred.*", image_name="y_pred", image_constructor=pkg.LabelMap,
            label_values={"left_whole": 1, "right_whole": 2}))
        out[pkg] = {s["name"]: np.asarray(s["y_pred"].data) for s in ds.subjects
                    if "y_pred" in s}
    assert out[tsp].keys() == out[jsp].keys() == {"cbbrain_000", "cbbrain_002"}
    for name in out[jsp]:
        np.testing.assert_array_equal(out[tsp][name], out[jsp][name])


def test_csv_and_tensor_loaders_match_jax(tmp_path):
    """AttributeLoader on a multi-subject CSV (pandas, imported when read)
    and TensorLoader on a whitespace-separated table."""
    (tmp_path / "s1").mkdir()
    (tmp_path / "table.csv").write_text("name,age,site\ns1,31,a\ns2,40,b\n")
    (tmp_path / "s1" / "bvals.txt").write_text("0  1000\t2000 \n")
    out = {}
    for pkg in (jsp, tsp):
        data = {"name": "s1", "folder": str(tmp_path / "s1")}
        pkg.ComposeLoaders(
            pkg.AttributeLoader("../table.csv", multi_subject=True, uniform=True),
            pkg.TensorLoader("bvals.txt", "bvals"))(data)
        out[pkg] = data
    assert out[tsp]["age"] == out[jsp]["age"] == 31 and out[tsp]["site"] == "a"
    np.testing.assert_array_equal(out[tsp]["bvals"], out[jsp]["bvals"])


@pytest.mark.parametrize("kind", ["folder", "tar"])
def test_prepare_dataset_files_matches_jax(dataset, tmp_path, kind):
    """A folder copied to the work path, or a tar extracted there: the same
    target in both packages, holding the dataset."""
    root, _ = dataset
    source = root
    if kind == "tar":
        source = tmp_path / "hippo.tar.gz"
        with tarfile.open(source, "w:gz") as tar:
            tar.add(root, arcname="hippo")
    out = {}
    for pkg, prepare in ((jsp, jprepare), (tsp, tprepare)):
        work = tmp_path / pkg.__name__
        target = prepare(str(source), str(work))
        out[pkg] = target.relative_to(work)
        assert (target / "subjects" / "cbbrain_000" / "mean_dwi.nii.gz").is_file()
        assert prepare(str(source), str(work)) == target  # a second call reuses it
    assert out[tsp] == out[jsp]
    assert tprepare(str(root)) == root
