"""dmri_hippo training entry points.

Ported from research/dmri_hippo/run.py, with its subcommands and options
and one more, ``--device`` (the card unless it says ``cpu``):

    python -m segmentation_pipeline_torch.research.dmri_hippo.run main <dataset> <logs> --fold 0
    python -m segmentation_pipeline_torch.research.dmri_hippo.run augmentation_experiment \
        <dataset> <logs> --augmentation-mode standard --fold 1
    python -m segmentation_pipeline_torch.research.dmri_hippo.run augmentation_experiment_grid \
        <dataset> <logs> --task-id 7
    python -m segmentation_pipeline_torch.research.dmri_hippo.run cascade_experiment \
        <dataset> <predictions> <logs> [--model-type basic_unet]
"""
import argparse
from itertools import product

from segmentation_pipeline_torch.loggers import FileLogger
from segmentation_pipeline_torch.utils.dataset_files import prepare_dataset_files

from .configs import augmentation, cascade, main_config


def _compute_dtype(args):
    return "bfloat16" if getattr(args, "bf16", False) else None


def _train(context, logging_path, max_training_time, num_workers,
           validation_batch_size=16, max_iterations=100000,
           preload=False):
    context.init_components()
    trainer = context.trainer
    trainer.train(
        context=context,
        max_iterations=max_iterations,
        max_training_time=max_training_time,
        preload_training_data=preload,
        preload_validation_data=preload,
        num_workers=num_workers,
        validation_batch_size=validation_batch_size,
        logger=FileLogger(logging_path),
    )


def main(args):
    dataset_path = prepare_dataset_files(args.dataset_path, args.work_path)
    context = main_config.get_context(
        device=getattr(args, "device", None),
        variables={"DATASET_PATH": str(dataset_path)},
        fold=args.fold, predict_hbt=args.predict_hbt,
        tpu_fast_path=getattr(args, "tpu_fast_path", False),
        compute_dtype=_compute_dtype(args))
    _train(context, args.logging_path, args.max_training_time, args.num_workers,
           max_iterations=args.max_iterations)


def debug(args):
    dataset_path = prepare_dataset_files(args.dataset_path, args.work_path)
    context = augmentation.get_context(
        device=getattr(args, "device", None),
        variables={"DATASET_PATH": str(dataset_path)},
        augmentation_mode="combined", fold=args.fold,
        predict_hbt=args.predict_hbt, training_batch_size=1)
    _train(context, args.logging_path, args.max_training_time, num_workers=0,
           validation_batch_size=1, max_iterations=args.max_iterations)


def augmentation_experiment(args):
    augmentation.check_mode(args.augmentation_mode)
    dataset_path = prepare_dataset_files(args.dataset_path, args.work_path)
    context = augmentation.get_context(
        device=getattr(args, "device", None),
        variables={"DATASET_PATH": str(dataset_path)},
        augmentation_mode=args.augmentation_mode, fold=args.fold,
        predict_hbt=args.predict_hbt,
        # with --tpu-fast-path the dwi_reconstruction and combined modes take
        # the hybrid split: the static channels stay in the device cache and
        # mean_dwi is regenerated on the host per batch and spliced in
        # (training/hybrid_augment.py)
        tpu_fast_path=getattr(args, "tpu_fast_path", False),
        compute_dtype=_compute_dtype(args))
    # preload also feeds the validation sweeps, which the device cache
    # does not replace
    _train(context, args.logging_path, args.max_training_time, args.num_workers,
           preload=True, max_iterations=args.max_iterations)


def augmentation_experiment_grid(args):
    grid_params = {
        "augmentation_mode": ["no_augmentation", "standard", "dwi_reconstruction",
                              "combined"],
        "fold": list(range(0, 5)),
    }
    configs = [dict(zip(grid_params.keys(), values))
               for values in product(*grid_params.values())]
    config = configs[args.task_id]
    args.augmentation_mode = config["augmentation_mode"]
    args.fold = config["fold"]
    augmentation_experiment(args)


def cascade_experiment(args):
    dataset_path = prepare_dataset_files(args.dataset_path, args.work_path)
    predictions_path = prepare_dataset_files(args.predictions_path, args.work_path)
    context = cascade.get_context(
        device=getattr(args, "device", None),
        variables={"DATASET_PATH": str(dataset_path),
                   "PREDICTIONS_PATH": str(predictions_path)},
        prior_label_name=args.prior_label_name, fold=args.fold,
        predict_hbt=args.predict_hbt, model_type=args.model_type)
    _train(context, args.logging_path, args.max_training_time, args.num_workers,
           preload=True, max_iterations=args.max_iterations)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, predictions=False):
        p.add_argument("dataset_path")
        if predictions:
            p.add_argument("predictions_path")
        p.add_argument("logging_path")
        p.add_argument("--work-path", default=None)
        p.add_argument("--fold", type=int, default=0)
        p.add_argument("--predict-hbt", action="store_true")
        p.add_argument("--max-training-time", default=None)
        p.add_argument("--max-iterations", type=int, default=100000)
        p.add_argument("--num-workers", type=int, default=4)
        p.add_argument("--tpu-fast-path", action="store_true",
                       help="device_cache + device_augmentation='auto': the training "
                            "volumes live on the device and the declared augmentation "
                            "pipeline runs batched there")
        p.add_argument("--bf16", action="store_true",
                       help="bfloat16 network compute with float32 master weights; omit "
                            "for float32")
        p.add_argument("--device", default=None,
                       help="torch device (default: the card; 'cpu' for the CPU)")

    p = sub.add_parser("main")
    common(p)
    p.set_defaults(func=main)

    p = sub.add_parser("debug")
    common(p)
    p.set_defaults(func=debug)

    p = sub.add_parser("augmentation_experiment")
    common(p)
    p.add_argument("--augmentation-mode", default="no_augmentation",
                   choices=list(augmentation.MODES))
    p.set_defaults(func=augmentation_experiment)

    p = sub.add_parser("augmentation_experiment_grid")
    common(p)
    p.add_argument("--task-id", type=int, default=0)
    p.set_defaults(func=augmentation_experiment_grid)

    p = sub.add_parser("cascade_experiment")
    common(p, predictions=True)
    p.add_argument("--prior-label-name", default="standard")
    p.add_argument("--model-type", default=None)
    p.set_defaults(func=cascade_experiment)

    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    args.func(args)
