"""Augmentation-ablation experiment.

Ported from research/dmri_hippo/configs/augmentation.py: start from the
base dmri_hippo context and swap the middle (augmentation) entry of the
training pipeline according to ``augmentation_mode``:

- ``no_augmentation``  — drop the augmentation block entirely
- ``standard``         — the geometric/intensity block from the base config
- ``dwi_reconstruction`` — physics-aware mean-DWI resynthesis only
- ``combined``         — DWI resynthesis followed by the standard block

The two DWI modes need ``ReconstructMeanDWI``, which the port does not have
yet: they raise naming its ROADMAP item.
"""
import os

from segmentation_pipeline_torch import (
    Compose,
    OneOf,
    RandomBiasField,
    RandomBlur,
    RandomElasticDeformation,
    RandomFlip,
    RandomGamma,
    RandomNoise,
    RescaleIntensity,
)
from segmentation_pipeline_torch.training.trainer import _not_ported

from . import main_config as base_config

MODES = ("no_augmentation", "standard", "dwi_reconstruction", "combined")
DWI_MODES = ("dwi_reconstruction", "combined")


def check_mode(augmentation_mode):
    """Raise for a mode that is not one of MODES, or that the port cannot
    build yet."""
    if augmentation_mode not in MODES:
        raise ValueError(f"Invalid augmentation mode {augmentation_mode}")
    if augmentation_mode in DWI_MODES:
        raise _not_ported(f"augmentation_mode={augmentation_mode!r} (ReconstructMeanDWI)",
                          "item 2 (the remaining host transforms)")


def _standard_block() -> Compose:
    """The base config's augmentation block, rebuilt here so the ablation can
    re-install it explicitly."""
    noise = RandomNoise(std=0.035, p=0.3)
    blur = RandomBlur((0, 1), p=0.2)
    return Compose([
        RandomFlip(axes=(0, 1, 2)),
        RandomElasticDeformation(p=0.5, num_control_points=(7, 7, 4),
                                 locked_borders=1, image_interpolation="bspline",
                                 exclude=["full_dwi"]),
        RandomBiasField(p=0.5),
        RescaleIntensity((0, 1), (0.01, 99.9)),
        RandomGamma(p=0.8),
        RescaleIntensity((-1, 1)),
        OneOf([Compose([blur, noise]), Compose([noise, blur])]),
    ], exclude=["full_dwi"])


def get_context(device=None, variables=None, augmentation_mode="standard", **kwargs):
    check_mode(augmentation_mode)

    context = base_config.get_context(device, variables, **kwargs)
    context.file_paths.append(os.path.abspath(__file__))
    context.config.update({"augmentation_mode": augmentation_mode})

    # the training pipeline is Compose([preprocessing, augmentation, model_io]);
    # index 1 is the slot this ablation swaps
    dataset_defn = context.get_component_definition("dataset")
    training_pipeline = dataset_defn["params"]["transforms"]["training"]
    if augmentation_mode == "no_augmentation":
        training_pipeline.transforms.pop(1)
    elif augmentation_mode == "standard":
        training_pipeline.transforms[1] = _standard_block()
    return context
