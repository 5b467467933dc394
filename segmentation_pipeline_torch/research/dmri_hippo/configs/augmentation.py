"""Augmentation-ablation experiment.

Ported from research/dmri_hippo/configs/augmentation.py: start from the
base dmri_hippo context and swap the middle (augmentation) entry of the
training pipeline according to ``augmentation_mode``:

- ``no_augmentation``  — drop the augmentation block entirely
- ``standard``         — the geometric/intensity block from the base config
- ``dwi_reconstruction`` — physics-aware mean-DWI resynthesis only
- ``combined``         — DWI resynthesis followed by the standard block

The two DWI modes load the full 4-D DWI series and its gradient table
(``full_dwi.*``, ``full_dwi_grad.b``) beside the base config's images.
"""
import os

from segmentation_pipeline_torch import (
    Compose,
    ImageLoader,
    OneOf,
    RandomBiasField,
    RandomBlur,
    RandomElasticDeformation,
    RandomFlip,
    RandomGamma,
    RandomNoise,
    ReconstructMeanDWI,
    RescaleIntensity,
    ScalarImage,
    TensorLoader,
)

from . import main_config as base_config

MODES = ("no_augmentation", "standard", "dwi_reconstruction", "combined")


def check_mode(augmentation_mode):
    """Raise for a mode that is not one of MODES."""
    if augmentation_mode not in MODES:
        raise ValueError(f"Invalid augmentation mode {augmentation_mode}")


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


def _dwi_block() -> ReconstructMeanDWI:
    return ReconstructMeanDWI(num_dwis=(1, 7), num_directions=(1, 3),
                              directionality=(4, 10))


def get_context(device=None, variables=None, augmentation_mode="standard", **kwargs):
    check_mode(augmentation_mode)

    context = base_config.get_context(device, variables, **kwargs)
    context.file_paths.append(os.path.abspath(__file__))
    context.config.update({"augmentation_mode": augmentation_mode})

    # the training pipeline is Compose([preprocessing, augmentation, model_io]);
    # index 1 is the slot this ablation swaps
    dataset_defn = context.get_component_definition("dataset")
    training_pipeline = dataset_defn["params"]["transforms"]["training"]

    if augmentation_mode in ("dwi_reconstruction", "combined"):
        # the full 4-D DWI series and its gradient table, which the base
        # config leaves out because the series is large
        loaders = dataset_defn["params"]["subject_loader"].loaders
        loaders.insert(0, ImageLoader(glob_pattern="full_dwi.*", image_name="full_dwi",
                                      image_constructor=ScalarImage))
        loaders.insert(1, TensorLoader(glob_pattern="full_dwi_grad.b", tensor_name="grad",
                                       belongs_to="full_dwi"))

    if augmentation_mode == "no_augmentation":
        training_pipeline.transforms.pop(1)
    elif augmentation_mode == "standard":
        training_pipeline.transforms[1] = _standard_block()
    elif augmentation_mode == "dwi_reconstruction":
        training_pipeline.transforms[1] = _dwi_block()
    elif augmentation_mode == "combined":
        training_pipeline.transforms[1] = Compose([_dwi_block(), _standard_block()])
    return context
