"""Weights & Biases logger, ported from
segmentation_pipeline_tpu/loggers/wandb_logger.py.

wandb is imported only when the logger is made or runs; without it the
constructor raises and names FileLogger, which covers the same duties
offline. The behaviours are the JAX package's: the run id is generated up
front and kept in the context's metadata for resume, a readable run name,
a retry loop on ``wandb.init``, min/max/mean summaries of every metric, the
source files uploaded on the first run only, each checkpoint written and
uploaded by ``save_context``, and the payload converted by type (the
evaluators' ``Table`` becomes a ``wandb.Table`` of the same columns and
rows, where the JAX package converts a DataFrame). Uploads go through
``_wandb_save``, which copies the file into the run directory first:
``wandb.save`` symlinks outside paths and uploads their bytes later, so an
overwritten checkpoint would upload stale bytes.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

from ..evaluators.labeled_tensor import LabeledTensor, Table
from .logger import Logger

# readable run-name suffix words
_NAME_WORDS = (
    "amber", "birch", "cedar", "delta", "ember", "fjord", "grove", "heron",
    "indigo", "juniper", "krill", "lumen", "maple", "nimbus", "onyx", "pico",
    "quartz", "raven", "sable", "tundra", "umber", "vapor", "willow", "xenon",
    "yarrow", "zephyr",
)


def to_wandb(value):
    import wandb

    if isinstance(value, Table):
        return wandb.Table(columns=list(value.columns),
                           data=[list(row) for row in zip(*value.columns.values())])
    try:
        from PIL import Image as PILImage

        if isinstance(value, PILImage.Image):
            return wandb.Image(value)
    except ImportError:
        pass
    if isinstance(value, LabeledTensor):
        return value.to_dict()
    if isinstance(value, dict):
        return {k: to_wandb(v) for k, v in value.items()}
    return value


class WandbLogger(Logger):
    def __init__(self, project_name: str, entity: str = None, group: str = None,
                 logs_dir: str = "./logs", init_retries: int = 5,
                 retry_delay: float = 5.0):
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "WandbLogger needs the wandb package, which is not installed here: install "
                "wandb, or log with segmentation_pipeline_torch.FileLogger instead.") from e
        self.project_name = project_name
        self.entity = entity
        self.group = group
        self.logs_dir = logs_dir
        self.init_retries = init_retries
        self.retry_delay = retry_delay
        self.run = None
        self.context = None
        self.save_folder = None

    def setup(self, context):
        import random

        import wandb

        self.context = context
        kwargs = dict(project=self.project_name, dir=None)
        if self.entity:
            kwargs["entity"] = self.entity
        if self.group:
            kwargs["group"] = self.group
        try:  # no symlinks (they break on Windows and colab), where the version takes it
            kwargs["settings"] = wandb.Settings(symlink=False)
        except (TypeError, ValueError):
            pass

        resuming = "wandb_run_id" in context.metadata
        if not resuming:
            # id generated up front and folded into the context metadata so
            # the checkpoint itself carries the resume handle
            run_id = context.metadata["wandb_run_id"] = wandb.util.generate_id()
            rng = random.Random(run_id)
            words = "-".join(rng.sample(_NAME_WORDS, 2))
            context.name = f"{context.name}-{words}-{run_id}"
            kwargs["id"] = run_id
            kwargs["name"] = context.name
            kwargs["config"] = context.get_config()
        else:
            kwargs["id"] = context.metadata["wandb_run_id"]
            kwargs["resume"] = "allow"

        parts = [self.logs_dir, self.project_name]
        if self.group:
            parts.append(self.group)
        parts.append(context.name)
        self.save_folder = os.path.join(*parts)
        os.makedirs(self.save_folder, exist_ok=True)
        kwargs["dir"] = self.save_folder

        last_error = None
        for attempt in range(self.init_retries):
            try:
                self.run = wandb.init(**kwargs)
                break
            except Exception as e:  # transient init failures of the service: retry
                last_error = e
                if attempt + 1 >= self.init_retries:
                    break  # no retry follows — don't announce one / sleep
                print(f"wandb.init failed due to {e}\nRetrying...")
                time.sleep(self.retry_delay)
        if self.run is None:
            raise RuntimeError(f"wandb.init failed after retries: {last_error}")

        # every logged metric also tracks min/max/mean summaries
        wandb.define_metric("*", summary="max")
        wandb.define_metric("*", summary="min")
        wandb.define_metric("*", summary="mean")

        if not resuming:  # source snapshot on the first run only
            for path in context.file_paths:
                if path and os.path.exists(path):
                    self._wandb_save(path)

    # (run_dir, upload name) -> source abspath: two DIFFERENT sources that
    # share a basename (e.g. dmri_hippo/config.py and msseg2/config.py in
    # context.file_paths) must not silently overwrite each other in the
    # run dir before upload
    _upload_names: dict = {}

    @classmethod
    def _wandb_save(cls, path):
        """Upload ``path``'s bytes as they exist NOW.

        Real ``wandb.save`` on a path outside the run directory creates a
        SYMLINK into the run dir; the sync loop reads the bytes later, by
        which time an overwritten checkpoint uploads stale (or missing)
        bytes. So the file is copied into the run dir and the copy saved
        (wandb uploads it directly, no symlink).
        """
        import hashlib
        import shutil

        import wandb

        src = os.path.abspath(str(path))
        run_dir = os.path.abspath(wandb.run.dir)
        name = os.path.basename(src)
        owner = cls._upload_names.get((run_dir, name))
        if owner is not None and owner != src:
            stem, ext = os.path.splitext(name)
            digest = hashlib.sha1(src.encode()).hexdigest()[:8]
            name = f"{stem}.{digest}{ext}"
        cls._upload_names[(run_dir, name)] = src
        dest = os.path.join(run_dir, name)
        if dest != src:
            shutil.copy2(src, dest)
        wandb.save(dest, base_path=run_dir, policy="now")

    def save_context(self, context, folder: str, iteration: int):
        out_dir = Path(self.save_folder) / folder
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{context.name}-iter{iteration:08}.ckpt"
        context.save(path)
        self._wandb_save(path)
        return path

    def log(self, log_dict: dict):
        import wandb

        wandb.log(to_wandb(log_dict))

    def close(self):
        import wandb

        if self.run is not None:
            try:
                wandb.finish()
            finally:
                self.run = None
