"""File-based experiment logger: JSONL metrics, checkpoints and images.

Ported from segmentation_pipeline_tpu/loggers/file_logger.py. ``setup``
writes ``config.json`` and opens ``metrics.jsonl``; ``save_context`` takes
the context's snapshot synchronously (host copies of every state, see
training/context.py) and writes it on one worker thread while training goes
on; ``log`` appends one JSON record and saves PIL images as PNG (PIL is
imported there); ``close`` drains the pending save. The JAX package's
TensorBoard mirror, orbax array storage and its synchronous-save and
no-image options are not ported: no caller sets them.
"""
from __future__ import annotations

import json
import math
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from pathlib import Path

import numpy as np

from ..evaluators.labeled_tensor import LabeledTensor, Table
from .logger import Logger


def _finite_or_none(value):
    """A table cell as JSON: non-finite floats become null, as the JAX
    package's DataFrame records do."""
    if isinstance(value, (np.floating, np.integer)):
        value = value.item()
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def _to_loggable(value):
    """Flatten evaluator outputs into JSON scalars / file artifacts."""
    if isinstance(value, LabeledTensor):
        return value.to_dict()
    if isinstance(value, Table):
        return [{k: _finite_or_none(v) for k, v in row.items()} for row in value.records()]
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, dict):
        return {k: _to_loggable(v) for k, v in value.items()}
    return value


class FileLogger(Logger):
    def __init__(self, logs_dir: str):
        self.logs_dir = logs_dir
        # checkpoint writes happen on a single worker thread: the state is
        # snapshotted to host synchronously and the pickle+disk write (the
        # slow part) overlaps with training
        self._save_executor = None
        self._pending_save = None
        self.run_dir = None
        self.metrics_file = None
        self.iteration = 0

    def setup(self, context):
        stamp = datetime.now().strftime("%y%m%d-%H%M%S")
        self.run_dir = Path(self.logs_dir) / f"{context.name}-{stamp}"
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_file = open(self.run_dir / "metrics.jsonl", "a")
        with open(self.run_dir / "config.json", "w") as f:
            json.dump(_to_loggable(context.get_config()), f, indent=2, default=str)

    def save_context(self, context, folder: str, iteration: int):
        out_dir = self.run_dir / folder
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{context.name}-iter{iteration:08}.ckpt"
        if self._save_executor is None:
            self._save_executor = ThreadPoolExecutor(max_workers=1)
        if self._pending_save is not None:
            self._pending_save.result()  # one write in flight at a time
        snapshot = context.snapshot()  # synchronous host copies
        self._pending_save = self._save_executor.submit(
            type(context).write_snapshot, snapshot, path)
        return path

    def log(self, log_dict: dict):
        # honor a caller-provided iteration (the trainer stamps its real one,
        # which survives resume) and fall back to a local counter
        iteration = log_dict.get("iteration", self.iteration)
        self.iteration = int(iteration)
        record = {"iteration": self.iteration}
        images = {}
        try:
            from PIL import Image as PILImage
        except ImportError:  # then no evaluator can have made an image
            PILImage = None

        def walk(prefix, value):
            if PILImage is not None and isinstance(value, PILImage.Image):
                images[prefix] = value
                return None
            if isinstance(value, dict):
                out = {}
                for k, v in value.items():
                    w = walk(f"{prefix}.{k}" if prefix else str(k), v)
                    if w is not None:
                        out[k] = w
                return out
            return _to_loggable(value)

        payload = walk("", log_dict)
        record.update(payload if isinstance(payload, dict) else {"value": payload})
        self.metrics_file.write(json.dumps(record, default=str) + "\n")
        self.metrics_file.flush()

        if images:
            img_dir = self.run_dir / "images"
            img_dir.mkdir(exist_ok=True)
            for name, img in images.items():
                safe = name.replace("/", "_")
                img.save(img_dir / f"{safe}-iter{self.iteration:08}.png")

        self.iteration += 1

    def close(self):
        if self._pending_save is not None:
            self._pending_save.result()
            self._pending_save = None
        if self._save_executor is not None:
            self._save_executor.shutdown(wait=True)
            self._save_executor = None
        if self.metrics_file is not None:
            self.metrics_file.close()
            self.metrics_file = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
