"""MSSEG2 training entry point.

Ported from research/msseg2/run.py, with its options and one more,
``--device`` (the card unless it says ``cpu``):

    python -m segmentation_pipeline_torch.research.msseg2.run <dataset> <logs> --fold 0
"""
import argparse

from segmentation_pipeline_torch.loggers import FileLogger
from segmentation_pipeline_torch.utils.dataset_files import prepare_dataset_files

from .msseg2 import get_context


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset_path")
    parser.add_argument("logging_path")
    parser.add_argument("--work-path", default=None)
    parser.add_argument("--fold", type=int, default=0)
    parser.add_argument("--max-training-time", default=None)
    parser.add_argument("--max-iterations", type=int, default=100000)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--tpu-fast-path", action="store_true",
                        help="device_cache + device_augmentation='auto': the volumes live "
                             "on the device and the declared augmentation pipeline runs "
                             "batched there")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 network compute with float32 master weights; omit "
                             "for float32")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' for the CPU)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    dataset_path = prepare_dataset_files(args.dataset_path, args.work_path)
    context = get_context(device=args.device, variables={"DATASET_PATH": str(dataset_path)},
                          fold=args.fold, tpu_fast_path=args.tpu_fast_path,
                          compute_dtype=("bfloat16" if args.bf16 else None))
    context.init_components()
    context.trainer.train(
        context=context,
        max_iterations=args.max_iterations,
        max_training_time=args.max_training_time,
        num_workers=args.num_workers,
        validation_batch_size=1,
        logger=FileLogger(args.logging_path),
    )


if __name__ == "__main__":
    main()
