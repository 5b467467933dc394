"""QSM deep-grey-matter multi-class segmentation experiment.

Ported from research/qsm_deep_grey_matter/qsm_deep_grey_matter.py with the
port's components: T1 and QSM inputs, the 17-structure label dict, the
removal of the ventricles and dentate nuclei, the merge of paired
left/right structures under the Right hemisphere mask, sequential
relabelling to 10 classes, and NestedResUNet(2 -> 10, 40 filters, dropout
0.2) on the model, the predictors and the optimizer state of ``device``
(None: the card).

    context = get_context(variables={"DATASET_PATH": path})
    context.init_components()
    context.trainer.train(context, max_iterations=..., logger=FileLogger(logs))

The JAX package has no CLI for it, and neither has the port.
"""
import os

from segmentation_pipeline_torch import (
    Adam,
    Compose,
    ComposeLoaders,
    ConcatenateImages,
    ContourImageEvaluator,
    Context,
    CopyProperty,
    Crop,
    CustomOneHot,
    CustomRemoveLabels,
    CustomSequentialLabels,
    ForbidAttributes,
    HybridLogisticDiceLoss,
    ImageLoader,
    LabelMap,
    MergeLabels,
    NestedResUNet,
    RandomSampler,
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

DGM_LABEL_VALUES = {
    "left_ventricle": 1, "right_ventricle": 2, "left_caudate": 3, "right_caudate": 4,
    "left_putamen": 5, "right_putamen": 6, "left_thalamus": 7, "right_thalamus": 8,
    "left_globus_pallidus": 9, "right_globus_pallidus": 10, "internal_capsule": 17,
    "left_red_nucleus": 19, "right_red_nucleus": 20,
    "left_substantia_nigra": 21, "right_substantia_nigra": 22,
    "left_dentate_nucleus": 23, "right_dentate_nucleus": 24,
}

VAL_SUBJECTS = ["Cb_Brain_058", "Cb_Brain_106"]


def get_context(device=None, variables=None, crop=(68, 68, 72, 72, 16, 16),
                filters=40, val_subjects=None, tpu_fast_path=False,
                microbatch=None, compute_dtype=None, **kwargs):
    """crop/filters default to the reference config; override only for
    small-scale smoke tests.

    The reference trains whole volumes at batch 4. The configuration's
    memory recipe: ``microbatch=2`` keeps the reference's effective batch
    through gradient accumulation (accumulate_steps = 4 // microbatch),
    ``tpu_fast_path=True`` adds block remat, the device cache and the
    device augmentation derived from the declared pipeline, and
    ``compute_dtype="bfloat16"`` runs the network in bfloat16 over float32
    weights."""
    context = Context(device, name="qsm-dgm", variables=variables)
    context.file_paths.append(os.path.abspath(__file__))
    if val_subjects is None:
        val_subjects = VAL_SUBJECTS

    subject_loader = ComposeLoaders([
        ImageLoader(glob_pattern="MPRAGE.*", image_name="t1",
                    image_constructor=ScalarImage),
        ImageLoader(glob_pattern="QSM.*", image_name="qsm",
                    image_constructor=ScalarImage),
        ImageLoader(glob_pattern="vB_PS_r.*", image_name="dgm",
                    image_constructor=LabelMap, label_values=dict(DGM_LABEL_VALUES)),
        ImageLoader(glob_pattern="IC.*", image_name="ic", image_constructor=LabelMap,
                    label_values={"internal_capsule": 17}),
        ImageLoader(glob_pattern="pulv.*", image_name="pulv",
                    image_constructor=LabelMap,
                    label_values={"left_thalamus_pulvinar": 7,
                                  "right_thalamus_pulvinar": 8}),
    ])

    cohorts = {
        "all": RequireAttributes(["t1", "qsm", "dgm"]),
        "training": ForbidAttributes({"name": list(val_subjects)}),
        "validation": RequireAttributes({"name": list(val_subjects)}),
    }

    transforms = {"default": Compose([
        RescaleIntensity((-1, 1), (0.1, 99.9)),
        Crop(tuple(crop)),
        CustomRemoveLabels(
            labels=["left_ventricle", "right_ventricle",
                    "left_dentate_nucleus", "right_dentate_nucleus"],
            include=["dgm"]),
        MergeLabels(
            merge_labels=[("left_caudate", "right_caudate"),
                          ("left_putamen", "right_putamen"),
                          ("left_globus_pallidus", "right_globus_pallidus"),
                          ("left_substantia_nigra", "right_substantia_nigra")],
            right_masking_method="Right", include=["dgm"]),
        CustomSequentialLabels(include=["dgm"]),
        ConcatenateImages(image_names=["t1", "qsm"], image_channels=[1, 1],
                          new_image_name="X"),
        CopyProperty(old_name="dgm", new_name="y"),
        CustomOneHot(num_classes=10, include=["y"]),
    ])}

    context.add_component("dataset", SubjectFolder, root="$DATASET_PATH",
                          subject_path="subjects", subject_loader=subject_loader,
                          cohorts=cohorts, transforms=transforms)
    context.add_component("model", NestedResUNet, input_channels=2,
                          output_channels=10, filters=filters, dropout_p=0.2,
                          remat=tpu_fast_path)
    batch_size = 4 if microbatch is None else int(microbatch)
    assert 4 % batch_size == 0, "microbatch must divide the reference batch 4"
    context.add_component("optimizer", Adam, lr=0.0002,
                          accumulate_steps=4 // batch_size)
    context.add_component("criterion", HybridLogisticDiceLoss)

    training_evaluators = [
        ScheduledEvaluation(evaluator=SegmentationEvaluator("y_pred_eval", "y_eval"),
                            log_name="training_segmentation_eval", interval=50),
    ]
    validation_evaluators = [
        ScheduledEvaluation(evaluator=SegmentationEvaluator("y_pred_eval", "y_eval"),
                            log_name="segmentation_eval", cohorts=["validation"],
                            interval=50),
        ScheduledEvaluation(evaluator=ContourImageEvaluator(
            "Axial", "qsm", "y_pred_eval", "y_eval", slice_id=9, legend=True,
            ncol=1, split_subjects=False),
            log_name="image0", subjects=list(val_subjects), interval=50),
        ScheduledEvaluation(evaluator=ContourImageEvaluator(
            "Coronal", "qsm", "y_pred_eval", "y_eval", slice_id=51, legend=True,
            ncol=1, split_subjects=False),
            log_name="image1", subjects=list(val_subjects), interval=50),
    ]

    def scoring_function(evaluation_dict):
        seg_eval = evaluation_dict["segmentation_eval"]["validation"]["summary_stats"]
        return float(seg_eval["mean", :, "dice"].mean())

    context.add_component("trainer", SegmentationTrainer,
                          training_batch_size=batch_size,
                          save_rate=250,
                          scoring_interval=50,
                          scoring_function=scoring_function,
                          one_time_evaluators=[],
                          training_evaluators=training_evaluators,
                          validation_evaluators=validation_evaluators,
                          max_iterations_with_no_improvement=2000,
                          train_predictor=StandardPredict(image_names=["X", "y"], device=device),
                          validation_predictor=StandardPredict(image_names=["X"], device=device),
                          train_dataloader_factory=StandardDataLoader(
                              sampler=RandomSampler),
                          validation_dataloader_factory=StandardDataLoader(
                              sampler=SequentialSampler),
                          device_cache=tpu_fast_path,
                          device_augmentation=(
                              "auto" if tpu_fast_path else None),
                          compute_dtype=compute_dtype)

    return context
