"""The port's derivation of the device augmentation from a declared pipeline
(segmentation_pipeline_torch/training/auto_augment.py) against the JAX
package's on the CPU: the derived config and the structure of the
deterministic host remainder on both configurations' training pipelines,
the mm-to-voxel conversion, the hybrid split, the refusals, and
``contains_random`` / ``describe_config``."""
import pytest

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from research.dmri_hippo.configs import main_config as jhippo
from research.msseg2 import msseg2 as jmsseg2
from segmentation_pipeline_torch.ops.augment import (DMRI_REFERENCE_CONFIG,
                                                     MSSEG2_REFERENCE_CONFIG)
from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config as thippo
from segmentation_pipeline_torch.research.msseg2 import msseg2 as tmsseg2
from segmentation_pipeline_torch.training import auto_augment as taa
from segmentation_pipeline_tpu.training import auto_augment as jaa

PACKAGES = {jsp: jaa, tsp: taa}


def training_pipeline(pkg, name):
    if name == "dmri_hippo":
        config = jhippo if pkg is jsp else thippo
        return config.build_transforms((96, 88, 24), False)["training"]
    config = jmsseg2 if pkg is jsp else tmsseg2
    return config.build_pipelines(96)["training"]


def structure(t):
    """Type names, nesting and target selections of a transform tree."""
    selection = (sorted(t.include) if t.include is not None else None,
                 sorted(t.exclude) if t.exclude else None)
    children = getattr(t, "transforms", None)
    if isinstance(children, list):
        return type(t).__name__, selection, [structure(c) for c in children]
    return type(t).__name__, selection


@pytest.mark.parametrize("spacing", [None, (2.0, 1.0, 0.5)])
@pytest.mark.parametrize("name", ["dmri_hippo", "msseg2"])
def test_derivation_matches_jax(name, spacing):
    out = {pkg: aa.derive_device_augmentation(training_pipeline(pkg, name), spacing)
           for pkg, aa in PACKAGES.items()}
    (jhost, jcfg), (thost, tcfg) = out[jsp], out[tsp]
    assert tcfg == jcfg
    assert structure(thost) == structure(jhost)
    assert not taa.contains_random(thost)
    assert taa.describe_config(tcfg) == jaa.describe_config(jcfg)
    if spacing is None:
        reference = DMRI_REFERENCE_CONFIG if name == "dmri_hippo" else MSSEG2_REFERENCE_CONFIG
        assert {k: tcfg[k] for k in reference} == reference
    if name == "msseg2":
        assert [type(t).__name__ for t in thost.transforms] == \
            ["Compose", "Compose", "ImageFromLabels"]


def test_spacing_converts_mm_to_voxels():
    _, cfg = taa.derive_device_augmentation(training_pipeline(tsp, "dmri_hippo"),
                                            spacing=(2.0, 1.0, 0.5))
    assert cfg["blur_spacing"] == (2.0, 1.0, 0.5)
    assert cfg["elastic_max_displacement"] == (7.5 / 2.0, 7.5, 7.5 / 0.5)


def resynthesis(pkg):
    """A host-only channel resynthesis in the shape the hybrid derivation
    looks for (ReconstructMeanDWI's attributes)."""
    class Resynthesize(pkg.RandomTransform):
        mean_dwi_image_name, full_dwi_image_name = "a", "full"

        def apply_transform(self, subject):
            return subject

    return Resynthesize()


def hybrid_pipeline(pkg):
    return pkg.Compose([
        resynthesis(pkg),
        pkg.RandomNoise(std=0.1, p=0.5),
        pkg.Compose([
            pkg.RescaleIntensity((-1, 1), (0.5, 99.5)),
            pkg.ConcatenateImages(image_names=["a", "b"], image_channels=[1, 1],
                                  new_image_name="X"),
            pkg.RenameProperty(old_name="seg", new_name="y"),
        ]),
    ])


def test_hybrid_split_matches_jax():
    (jhost, jcfg, jspec), (thost, tcfg, tspec) = (
        aa.derive_hybrid_augmentation(hybrid_pipeline(pkg)) for pkg, aa in PACKAGES.items())
    assert tcfg == jcfg and structure(thost) == structure(jhost)
    assert (tspec.slots, tspec.image_order, tspec.n_channels) == \
        (jspec.slots, jspec.image_order, jspec.n_channels) == ({"a": (0, 1)}, ["a"], 1)
    assert [structure(t) for t in tspec.finishers] == [structure(t) for t in jspec.finishers]
    assert structure(tspec.host_inline) == structure(jspec.host_inline)
    assert repr(tspec) == repr(jspec)
    plain = taa.derive_hybrid_augmentation(training_pipeline(tsp, "msseg2"))
    assert plain[2] is None and plain[1] == taa.derive_device_augmentation(
        training_pipeline(tsp, "msseg2"))[1]


def refusals(pkg):
    class RandomUnknown(pkg.RandomTransform):
        def apply_transform(self, subject):
            return subject

    return {
        "unmappable": (pkg.Compose([RandomUnknown()]), "RandomUnknown"),
        "noise mean": (pkg.Compose([pkg.RandomNoise(mean=0.5, std=0.1)]), "zero-mean"),
        "out of order": (pkg.Compose([pkg.RandomGamma(p=0.5), pkg.RandomBiasField(p=0.5)]),
                         "out of order"),
        "non-commuting suffix": (pkg.Compose([pkg.RandomFlip(axes=(0, 1, 2)),
                                              pkg.CropOrPad((8, 8, 8))]), "CropOrPad"),
        "exclude of a batch source": (pkg.Compose([
            pkg.RandomNoise(std=0.1, p=0.5, exclude=["a"]),
            pkg.Compose([pkg.ConcatenateImages(image_names=["a", "b"], image_channels=[1, 1],
                                               new_image_name="X"),
                         pkg.RenameProperty(old_name="seg", new_name="y")])]),
            "excludes \\['a'\\]"),
        "random compose": (pkg.Compose([pkg.Compose([pkg.RandomFlip()], p=0.5)]),
                           "Compose\\(p=0.5\\)"),
    }


@pytest.mark.parametrize("case", ["unmappable", "noise mean", "out of order",
                                  "non-commuting suffix", "exclude of a batch source",
                                  "random compose"])
def test_refusals_match_jax(case):
    for pkg, aa in PACKAGES.items():
        pipeline, match = refusals(pkg)[case]
        with pytest.raises(aa.AugmentationDerivationError, match=match):
            aa.derive_device_augmentation(pipeline)


def test_contains_random_and_no_randomness():
    assert taa.contains_random(tsp.RandomNoise(std=0.1))
    assert taa.contains_random(tsp.Compose([tsp.ReplaceNan(), tsp.RandomFlip()]))
    assert taa.contains_random(tsp.OneOf([tsp.ReplaceNan()]))
    assert taa.contains_random(tsp.RescaleIntensity((0, 1), p=0.5))
    assert not taa.contains_random(None)
    t = tsp.Compose([tsp.RescaleIntensity((0, 1)), tsp.CustomOneHot(include=["y"])])
    assert not taa.contains_random(t)
    host, cfg = taa.derive_device_augmentation(t)
    assert cfg is None and host is t
