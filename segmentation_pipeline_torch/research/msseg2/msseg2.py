"""MSSEG2 longitudinal new-lesion segmentation experiment.

Ported from research/msseg2/msseg2.py with the port's components: two-
timepoint FLAIR inputs, 1 mm resample, crop to the brain and minimum pad,
the spatial and intensity augmentation, lesion-weighted 96^3 patch
sampling, the depth-6 BlurConv ModularUNet with rematerialized blocks, the
class-weighted hybrid loss, patch-based validation and nan-aware Dice
scoring. The model and the predictors live on ``device`` (None: the card).
"""
import os

import numpy as np

from segmentation_pipeline_torch import (
    SGD,
    BlurConv3d,
    BlurConvTranspose3d,
    Compose,
    ComposeLoaders,
    ConcatenateImages,
    ContourImageEvaluator,
    Context,
    CropToMask,
    CustomOneHot,
    EnforceConsistentAffine,
    HybridLogisticDiceLoss,
    ImageFromLabels,
    ImageLoader,
    LabelMap,
    LabelMapEvaluator,
    MinSizePad,
    ModularUNet,
    NegateFilter,
    OneOf,
    PatchDataLoader,
    PatchPredict,
    RandomAffine,
    RandomBiasField,
    RandomBlur,
    RandomElasticDeformation,
    RandomFlip,
    RandomFoldFilter,
    RandomGamma,
    RandomNoise,
    RandomPermuteDimensions,
    RenameProperty,
    RequireAttributes,
    RescaleIntensity,
    ScalarImage,
    ScheduledEvaluation,
    SegmentationEvaluator,
    SegmentationTrainer,
    SequentialSampler,
    SetDataType,
    StandardDataLoader,
    StandardPredict,
    SubjectFolder,
    TargetResample,
    WeightedSampler,
)

TIMEPOINTS = ("flair_time01", "flair_time02")


def build_ingestion():
    return ComposeLoaders([
        ImageLoader(glob_pattern="flair_time01*", image_name="flair_time01",
                    image_constructor=ScalarImage),
        ImageLoader(glob_pattern="flair_time02*", image_name="flair_time02",
                    image_constructor=ScalarImage),
        ImageLoader(glob_pattern="brain_mask.*", image_name="brain_mask",
                    image_constructor=LabelMap, label_values={"brain": 1}),
        ImageLoader(glob_pattern="ground_truth.*", image_name="ground_truth",
                    image_constructor=LabelMap, label_values={"lesion": 1}),
    ])


def build_pipelines(patch_size: int) -> dict:
    """Geometry normalization -> (training only) spatial+intensity
    augmentation -> model I/O staging -> (training only) the lesion-weighted
    patch-probability map consumed by the WeightedSampler."""
    normalize_geometry = Compose([
        SetDataType(np.float32),
        EnforceConsistentAffine(source_image_name="flair_time01"),
        TargetResample(target_spacing=1, tolerance=0.11),
        CropToMask("brain_mask"),
        MinSizePad(patch_size),
    ])

    augment = Compose([
        RandomPermuteDimensions(),
        RandomFlip(axes=(0, 1, 2)),
        OneOf({
            RandomElasticDeformation(): 0.2,
            RandomAffine(scales=0.2, degrees=45, default_pad_value="otsu"): 0.8,
        }, p=0.75),
        RandomBiasField(p=0.5),
        RescaleIntensity((0, 1), (0.01, 99.9)),
        RandomGamma(p=0.8),
        RescaleIntensity((-1, 1)),
        RandomBlur((0, 1), p=0.2),
        RandomNoise(std=0.1, p=0.35),
    ])

    stage_model_io = Compose([
        RescaleIntensity((-1, 1.0), (0.05, 99.5)),
        ConcatenateImages(image_names=list(TIMEPOINTS), image_channels=[1, 1],
                          new_image_name="X"),
        RenameProperty(old_name="ground_truth", new_name="y"),
        CustomOneHot(include="y"),
    ])

    lesion_weighted_map = ImageFromLabels(
        new_image_name="patch_probability",
        label_weights=[("brain_mask", "brain", 1), ("y", "lesion", 100)])

    return {
        "default": Compose([normalize_geometry, stage_model_io]),
        "training": Compose([normalize_geometry, augment, stage_model_io,
                             lesion_weighted_map]),
    }


def nan_aware_lesion_dice(evaluation_dict) -> float:
    """Mean lesion Dice with 0/0 (correctly empty prediction) scored 1.0 and
    >0/0 (false-positive lesions on a lesion-free subject) scored 0.0."""
    seg_eval = evaluation_dict["segmentation_eval"]["validation"]
    dice = np.asarray(seg_eval["subject_stats"]["dice"], dtype=np.float64)
    dice = np.nan_to_num(dice, nan=1.0, posinf=0.0)
    return float(dice.mean())


def get_context(device=None, variables=None, fold=0, patch_size=96,
                filters=(40, 40, 80, 80, 120, 120), tpu_fast_path=False,
                compute_dtype=None, **kwargs):
    """patch_size/filters default to the reference config; override only
    for small-scale smoke tests.

    tpu_fast_path=True turns on the device training levers with no
    hand-written augmentation dict: device_cache=True (volumes on the
    device, patches sampled there) and device_augmentation="auto"
    (training/auto_augment.py derives the device augmentation from this
    file's declared pipeline; it applies to the sampled patch)."""
    context = Context(device, name="msseg2", variables=variables)
    context.file_paths.append(os.path.abspath(__file__))
    context.config = {"fold": fold, "patch_size": patch_size}

    validation_cohort = RandomFoldFilter(num_folds=5, selection=fold,
                                         seed=0xDEADBEEF)
    cohorts = {
        "all": RequireAttributes(list(TIMEPOINTS)),
        "validation": validation_cohort,
        "training": NegateFilter(validation_cohort),
    }

    context.add_component("dataset", SubjectFolder, root="$DATASET_PATH",
                          subject_path="", subject_loader=build_ingestion(),
                          cohorts=cohorts,
                          transforms=build_pipelines(patch_size))
    context.add_component("model", ModularUNet,
                          in_channels=2, out_channels=2,
                          filters=list(filters), depth=len(filters),
                          block_params={"residual": True},
                          downsample_class=BlurConv3d,
                          downsample_params={"kernel_size": 3, "stride": 2,
                                             "padding": 1},
                          upsample_class=BlurConvTranspose3d,
                          upsample_params={"kernel_size": 3, "stride": 2,
                                           "padding": 1, "output_padding": 0},
                          remat=True)
    context.add_component("optimizer", SGD, lr=0.001, momentum=0.95)
    context.add_component("criterion", HybridLogisticDiceLoss,
                          logistic_class_weights=[1, 100])

    training_evaluators = [
        ScheduledEvaluation(evaluator=SegmentationEvaluator("y_pred_eval", "y_eval"),
                            log_name="training_segmentation_eval", interval=15),
        ScheduledEvaluation(evaluator=LabelMapEvaluator("y_pred_eval"),
                            log_name="training_label_eval", interval=15),
        ScheduledEvaluation(evaluator=ContourImageEvaluator(
            "random", "flair_time02", "y_pred_eval", "y_eval",
            slice_id=0, legend=True, ncol=2, interesting_slice=True,
            split_subjects=False),
            log_name="contour_image", interval=15),
    ]
    validation_evaluators = [
        ScheduledEvaluation(evaluator=SegmentationEvaluator("y_pred_eval", "y_eval"),
                            log_name="segmentation_eval", cohorts=["validation"],
                            interval=50),
        ScheduledEvaluation(evaluator=ContourImageEvaluator(
            "interesting", "flair_time02", "y_pred_eval", "y_eval",
            slice_id=0, legend=True, ncol=1, interesting_slice=True,
            split_subjects=True),
            log_name="contour_image", cohorts=["validation"], interval=50),
    ]

    context.add_component(
        "trainer", SegmentationTrainer,
        training_batch_size=4,
        save_rate=100,
        scoring_interval=50,
        scoring_function=nan_aware_lesion_dice,
        one_time_evaluators=[],
        training_evaluators=training_evaluators,
        validation_evaluators=validation_evaluators,
        max_iterations_with_no_improvement=2000,
        train_predictor=StandardPredict(image_names=["X", "y"], device=device),
        validation_predictor=PatchPredict(
            patch_batch_size=32,
            patch_size=patch_size,
            patch_overlap=(patch_size // 8),
            padding_mode=None,
            overlap_mode="average",
            image_names=["X"],
            device=device),
        train_dataloader_factory=PatchDataLoader(
            max_length=100, samples_per_volume=1,
            sampler=WeightedSampler(patch_size=patch_size,
                                    probability_map="patch_probability")),
        validation_dataloader_factory=StandardDataLoader(
            sampler=SequentialSampler),
        device_cache=tpu_fast_path,
        device_augmentation="auto" if tpu_fast_path else None,
        compute_dtype=compute_dtype)
    return context
