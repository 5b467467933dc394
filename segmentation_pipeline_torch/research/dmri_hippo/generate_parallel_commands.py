"""Print commands for embarrassingly-parallel job-array sweeps of the port's
dmri_hippo augmentation experiment.

Ported from research/dmri_hippo/generate_parallel_commands.py: each
combination from the cartesian product of ``params`` is assigned to a
job-array task; pipe the output to ``parallel`` in a cluster job script.
The CPU budget of a task is divided among the configs assigned to it. The
commands start the port's CLI, which trains on the card.

    SLURM_ARRAY_TASK_COUNT=4 SLURM_ARRAY_TASK_ID=0 SLURM_CPUS_PER_TASK=8 \
        SLURM_TMPDIR=$TMPDIR \
        python -m segmentation_pipeline_torch.research.dmri_hippo.generate_parallel_commands \
        | parallel
"""
import itertools
import os
import tempfile
from pathlib import Path

RUN_MODULE = "segmentation_pipeline_torch.research.dmri_hippo.run"

params = {
    "aug_method": ["no_augmentation", "standard", "dwi_reconstruction", "combined"],
    "fold": range(0, 5),
}


def main(task_count, task_id, cpus_per_job, tmpdir,
         dataset_path="$DATASET_TAR", logging_path="$LOGS_PATH",
         group_name="augmentation_experiment_01"):
    configs = [dict(zip(params.keys(), values))
               for values in itertools.product(*params.values())]

    current = [c for i, c in enumerate(configs) if i % task_count == task_id]
    if not current:  # more array tasks than configs: nothing for this id
        return

    cpu_list = [0] * len(current)
    for i in range(cpus_per_job):
        cpu_list[i % len(current)] += 1

    for i, config in enumerate(current):
        data_dir = Path(tmpdir) / f"{i}"
        data_dir.mkdir(parents=True, exist_ok=True)
        print(
            f"python -m {RUN_MODULE} augmentation_experiment "
            f"{dataset_path} {logging_path} "
            f"--work-path {data_dir} "
            f"--augmentation-mode {config['aug_method']} "
            "--max-training-time 0-8:0:0 "
            f"--num-workers {cpu_list[i]} "
            f"--fold {config['fold']} "
        )


if __name__ == "__main__":
    main(
        int(os.environ.get("SLURM_ARRAY_TASK_COUNT", "1")),
        int(os.environ.get("SLURM_ARRAY_TASK_ID", "0")),
        int(os.environ.get("SLURM_CPUS_PER_TASK", "4")),
        os.environ.get("SLURM_TMPDIR", tempfile.gettempdir()),
    )
