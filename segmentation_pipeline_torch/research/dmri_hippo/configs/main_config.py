"""dmri_hippo canonical experiment: hippocampus segmentation from dMRI.

Ported from research/dmri_hippo/configs/main_config.py with the port's
components: the same modalities, label dicts, cohort rules, transform
order, evaluator schedule and hyperparameters. Small builders assemble each
concern (ingestion, cohorts, transform pipelines, evaluation schedule), and
``get_context`` registers the five components (dataset, model, optimizer,
criterion, trainer) on the Context, the model and the predictors on
``device`` (None: the card).

    context = get_context(variables={"DATASET_PATH": path})
    context.init_components()
    context.trainer.train(context, max_iterations=..., num_workers=4,
                          logger=FileLogger(logs))
"""
import os

import numpy as np

from segmentation_pipeline_torch import (
    Adam,
    AttributeLoader,
    Compose,
    ComposeFilters,
    ComposeLoaders,
    ConcatenateImages,
    ContourImageEvaluator,
    Context,
    CropOrPad,
    CustomOneHot,
    CustomRemapLabels,
    ForbidAttributes,
    HybridLogisticDiceLoss,
    ImageLoader,
    LabelMap,
    LabelMapEvaluator,
    NestedResUNet,
    OneOf,
    RandomBiasField,
    RandomBlur,
    RandomElasticDeformation,
    RandomFlip,
    RandomGamma,
    RandomNoise,
    RandomSampler,
    RandomSelectFilter,
    RenameProperty,
    ReplaceNan,
    RequireAttributes,
    RescaleIntensity,
    ScalarImage,
    ScheduledEvaluation,
    SegmentationEvaluator,
    SegmentationTrainer,
    SequentialSampler,
    StandardDataLoader,
    StandardPredict,
    SubjectFolder,
)

# modalities fed to the model (channel-concatenated into X)
INPUT_IMAGES = ("mean_dwi", "md", "fa")

WHOLE_LABELS = {"left_whole": 1, "right_whole": 2}
HBT_LABELS = {"left_head": 1, "left_body": 2, "left_tail": 3,
              "right_head": 4, "right_body": 5, "right_tail": 6}

# volume-vs-age regression curves for the unlabeled ab300 plausibility check
CURVE_PARAMS = {
    "left_whole": np.array([-1.96312119e-01, 9.46668029e+00, 2.33635173e+03]),
    "right_whole": np.array([-2.68467331e-01, 1.67925603e+01, 2.07224236e+03]),
}

def build_subject_loader() -> ComposeLoaders:
    """Glob-driven ingestion: three scalar modalities, the segmentation
    targets (whole + head/body/tail variants), the shared atlas union mask,
    and per-subject + dataset-level attribute files."""
    return ComposeLoaders([
        ImageLoader(glob_pattern="mean_dwi.*", image_name="mean_dwi",
                    image_constructor=ScalarImage),
        ImageLoader(glob_pattern="md.*", image_name="md", image_constructor=ScalarImage),
        ImageLoader(glob_pattern="fa.*", image_name="fa", image_constructor=ScalarImage),
        ImageLoader(glob_pattern="whole_roi.*", image_name="whole_roi",
                    image_constructor=LabelMap, label_values=dict(WHOLE_LABELS)),
        ImageLoader(glob_pattern="whole_roi_alt.*", image_name="whole_roi_alt",
                    image_constructor=LabelMap, label_values=dict(WHOLE_LABELS)),
        ImageLoader(glob_pattern="hbt_roi.*", image_name="hbt_roi",
                    image_constructor=LabelMap, label_values=dict(HBT_LABELS)),
        ImageLoader(glob_pattern="../../atlas/whole_roi_union.*",
                    image_name="whole_roi_union", image_constructor=LabelMap,
                    uniform=True),
        AttributeLoader(glob_pattern="attributes.*"),
        AttributeLoader(glob_pattern="../../attributes/cross_validation_split.json",
                        multi_subject=True, uniform=True),
        AttributeLoader(glob_pattern="../../attributes/ab300_validation_subjects.json",
                        multi_subject=True, uniform=True),
        AttributeLoader(glob_pattern="../../attributes/cbbrain_test_subjects.json",
                        multi_subject=True, uniform=True),
    ])


def build_cohorts(fold: int) -> dict:
    """Named cohort algebra: CV folds, held-out test, unlabeled ab300
    validation, scanner protocols, rescans, pathology, inter-rater."""
    cross_validation = RequireAttributes(["fold"])
    ab300_validation = RequireAttributes({"ab300_validation": True})
    return {
        "all": RequireAttributes(list(INPUT_IMAGES)),
        "cross_validation": cross_validation,
        "training": ComposeFilters([cross_validation,
                                    ForbidAttributes({"fold": fold})]),
        "cbbrain_validation": ComposeFilters([cross_validation,
                                              RequireAttributes({"fold": fold})]),
        "cbbrain_test": RequireAttributes({"cbbrain_test": True}),
        "ab300_validation": ab300_validation,
        "ab300_validation_plot": ComposeFilters(
            [ab300_validation, RandomSelectFilter(num_subjects=20)]),
        "cbbrain": RequireAttributes({"protocol": "cbbrain"}),
        "ab300": RequireAttributes({"protocol": "ab300"}),
        "rescans": ForbidAttributes({"rescan_id": "None"}),
        "fasd": RequireAttributes({"pathologies": "FASD"}),
        "inter_rater": RequireAttributes(["whole_roi_alt"]),
    }


def build_transforms(crop_shape, predict_hbt: bool) -> dict:
    """default = deterministic preprocessing; training = same + the heavy
    stochastic augmentation block in the middle (augmentation.py swaps that
    middle entry for the ablation study)."""
    preprocessing = Compose([
        ReplaceNan(),
        CropOrPad(tuple(crop_shape), padding_mode="minimum",
                  mask_name="whole_roi_union"),
        # collapse left/right ids to a single per-structure id inside each
        # hemisphere so the sagittal-split model sees one label space
        CustomRemapLabels(remapping=[("right_whole", 2, 1)],
                          masking_method="Right", include=["whole_roi"]),
        CustomRemapLabels(remapping=[("right_head", 4, 1), ("right_body", 5, 2),
                                     ("right_tail", 6, 3)],
                          masking_method="Right", include=["hbt_roi"]),
    ])

    noise = RandomNoise(std=0.035, p=0.3)
    blur = RandomBlur((0, 1), p=0.2)
    augmentation = Compose([
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

    target = "hbt_roi" if predict_hbt else "whole_roi"
    model_io = Compose([
        RescaleIntensity((-1.0, 1.0), (0.5, 99.5)),
        ConcatenateImages(image_names=list(INPUT_IMAGES),
                          image_channels=[1, 1, 1], new_image_name="X"),
        RenameProperty(old_name=target, new_name="y"),
        CustomOneHot(include=["y"]),
    ])

    return {
        "default": Compose([preprocessing, model_io]),
        "training": Compose([preprocessing, augmentation, model_io]),
    }


def build_evaluation_schedule():
    """Interval-gated evaluators: quick Dice + contour montage on training
    batches; Dice/age-curve/montage sweeps over validation cohorts."""
    training_evaluators = [
        ScheduledEvaluation(evaluator=SegmentationEvaluator("y_pred_eval", "y_eval"),
                            log_name="training_segmentation_eval", interval=10),
        ScheduledEvaluation(evaluator=ContourImageEvaluator(
            "Axial", "mean_dwi", "y_pred_eval", "y_eval",
            slice_id=12, legend=True, ncol=2, split_subjects=False),
            log_name="contour_image_training", interval=50),
    ]
    validation_evaluators = [
        ScheduledEvaluation(evaluator=LabelMapEvaluator(
            "y_pred_eval", curve_params=CURVE_PARAMS, curve_attribute="age",
            stats_to_output=("volume", "error", "absolute_error", "squared_error",
                             "percent_diff")),
            log_name="predicted_label_eval",
            cohorts=["cbbrain_validation", "ab300_validation"], interval=50),
        ScheduledEvaluation(evaluator=SegmentationEvaluator("y_pred_eval", "y_eval"),
                            log_name="segmentation_eval",
                            cohorts=["cbbrain_validation"], interval=50),
        ScheduledEvaluation(evaluator=ContourImageEvaluator(
            "Axial", "mean_dwi", "y_pred_eval", "y_eval",
            slice_id=10, legend=True, ncol=5, split_subjects=False),
            log_name="contour_image_axial",
            cohorts=["cbbrain_validation", "ab300_validation_plot"], interval=250),
        ScheduledEvaluation(evaluator=ContourImageEvaluator(
            "Coronal", "mean_dwi", "y_pred_eval", "y_eval",
            slice_id=44, legend=True, ncol=2, split_subjects=False),
            log_name="contour_image_coronal",
            cohorts=["cbbrain_validation", "ab300_validation_plot"], interval=250),
    ]
    return training_evaluators, validation_evaluators


def cbbrain_dice_score(evaluation_dict) -> float:
    """Model score = mean Dice over labels on the cbbrain validation cohort."""
    summary = evaluation_dict["segmentation_eval"]["cbbrain_validation"][
        "summary_stats"]
    return float(summary["mean", :, "dice"].mean())


def get_context(device=None, variables=None, fold=0, predict_hbt=False,
                training_batch_size=4, crop_shape=(96, 88, 24), filters=40,
                tpu_fast_path=False, compute_dtype=None):
    """crop_shape/filters default to the reference config; override only
    for small-scale smoke tests. compute_dtype="bfloat16" runs the network
    forward and backward in bf16 over float32 weights and loss.

    tpu_fast_path=True turns on the device training levers with no
    hand-written augmentation dict: device_cache=True (the deterministic
    pipeline pretransformed once, the training set on the device) and
    device_augmentation="auto" (training/auto_augment.py derives the device
    augmentation from this file's declared pipeline)."""
    context = Context(device, name="dmri-hippo", variables=variables)
    context.file_paths.append(os.path.abspath(__file__))
    context.config.update({"fold": fold})

    training_evaluators, validation_evaluators = build_evaluation_schedule()

    context.add_component("dataset", SubjectFolder, root="$DATASET_PATH",
                          subject_path="subjects",
                          subject_loader=build_subject_loader(),
                          cohorts=build_cohorts(fold),
                          transforms=build_transforms(crop_shape, predict_hbt),
                          ref_img="mean_dwi")
    context.add_component("model", NestedResUNet,
                          input_channels=len(INPUT_IMAGES),
                          output_channels=4 if predict_hbt else 2,
                          filters=filters,
                          dropout_p=0.2)
    context.add_component("optimizer", Adam, lr=0.0002)
    context.add_component("criterion", HybridLogisticDiceLoss)
    context.add_component("trainer", SegmentationTrainer,
                          training_batch_size=training_batch_size,
                          save_rate=100,
                          scoring_interval=50,
                          scoring_function=cbbrain_dice_score,
                          one_time_evaluators=[],
                          training_evaluators=training_evaluators,
                          validation_evaluators=validation_evaluators,
                          max_iterations_with_no_improvement=2000,
                          train_predictor=StandardPredict(
                              sagittal_split=True, image_names=["X", "y"], device=device),
                          validation_predictor=StandardPredict(
                              sagittal_split=True, image_names=["X"], device=device),
                          train_dataloader_factory=StandardDataLoader(
                              sampler=RandomSampler),
                          validation_dataloader_factory=StandardDataLoader(
                              sampler=SequentialSampler),
                          device_cache=tpu_fast_path,
                          device_augmentation="auto" if tpu_fast_path else None,
                          compute_dtype=compute_dtype)
    return context
