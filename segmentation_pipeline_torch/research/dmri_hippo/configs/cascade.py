"""Two-stage cascade refinement experiment, ported from
research/dmri_hippo/configs/cascade.py: the dmri_hippo base context plus a
prior prediction (``y_prior``, read from
``$PREDICTIONS_PATH/subjects/<name>/<prior_label_name>.*``), remapped like
the target and one-hot encoded; the model's head becomes a StochasticMatrix
of C^2 outputs (NestedResUNet by default, ``model_type="basic_unet"`` for
ModularUNet with blurred strided and transposed convs and ``diag_bias=5``);
SGD; and both predictors refine the prior (``refine_image="y_prior"``).

    context = get_context(variables={"DATASET_PATH": ..., "PREDICTIONS_PATH": ...})
"""
import os

from segmentation_pipeline_torch import (
    SGD,
    BlurConv3d,
    BlurConvTranspose3d,
    CustomOneHot,
    CustomRemapLabels,
    ImageLoader,
    LabelMap,
    ModularUNet,
    StandardPredict,
)
from segmentation_pipeline_torch.models import StochasticMatrix

from . import main_config as base_config

MODEL_TYPES = (None, "basic_unet")


def get_context(device=None, variables=None, prior_label_name="standard",
                model_type=None, **kwargs):
    """``kwargs`` go to main_config.get_context (fold, predict_hbt,
    crop_shape, filters, ...)."""
    context = base_config.get_context(device, variables, **kwargs)
    context.file_paths.append(os.path.abspath(__file__))
    context.config.update({
        "prior_label_name": prior_label_name,
        "model_type": model_type,
        "optimizer": "SGD",
    })

    dataset_defn = context.get_component_definition("dataset")
    subject_loader = dataset_defn["params"]["subject_loader"]
    subject_loader.loaders.append(
        ImageLoader(
            glob_pattern=f"$PREDICTIONS_PATH/subjects/$SUBJECT_NAME/{prior_label_name}.*",
            image_name="y_prior", image_constructor=LabelMap,
            label_values={"left_whole": 1, "right_whole": 2}))

    # y_prior goes through the spatial preprocessing with every image; like
    # whole_roi it takes the hemisphere remap (right_whole 2 -> 1 under the
    # Right mask), so its one-hot matches the model's C=2 transition head
    default_transform = dataset_defn["params"]["transforms"]["default"]
    common_transforms_1, common_transforms_2 = default_transform.transforms
    common_transforms_1.transforms.append(
        CustomRemapLabels(remapping=[("right_whole", 2, 1)],
                          masking_method="Right", include=["y_prior"]))
    common_transforms_2.transforms += [CustomOneHot(include=["y_prior"])]

    output_channels = 4 if kwargs.get("predict_hbt") else 2
    model_defn = context.get_component_definition("model")
    if model_type is None:
        model_params = model_defn["params"]
        model_params["output_channels"] = output_channels * output_channels
        model_params["hypothesis_class"] = StochasticMatrix
        model_params["hypothesis_params"] = {"channels": output_channels}
    elif model_type == "basic_unet":
        model_defn["constructor"] = ModularUNet
        model_defn["params"] = {
            "in_channels": 3,
            "out_channels": output_channels * output_channels,
            "filters": [40, 80, 120],
            "depth": 3,
            "block_params": {"residual": True},
            "downsample_class": BlurConv3d,
            "downsample_params": {"kernel_size": 3, "stride": 2, "padding": 1},
            "upsample_class": BlurConvTranspose3d,
            "upsample_params": {"kernel_size": 3, "stride": 2, "padding": 1,
                                "output_padding": 0},
            "hypothesis_class": StochasticMatrix,
            "hypothesis_params": {"channels": output_channels, "diag_bias": 5},
        }
    else:
        raise ValueError(f"model_type must be one of {MODEL_TYPES}; got {model_type!r}")

    optimizer_defn = context.get_component_definition("optimizer")
    optimizer_defn["constructor"] = SGD
    optimizer_defn["params"] = {"lr": 0.01, "momentum": 0.95}

    trainer_params = context.get_component_definition("trainer")["params"]
    trainer_params["train_predictor"] = StandardPredict(
        sagittal_split=True, image_names=["X", "y"], refine_image="y_prior", device=device)
    trainer_params["validation_predictor"] = StandardPredict(
        sagittal_split=True, image_names=["X"], refine_image="y_prior", device=device)

    return context
