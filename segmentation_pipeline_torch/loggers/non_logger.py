"""No-op logger, copied from segmentation_pipeline_tpu/loggers/non_logger.py."""
from __future__ import annotations

from .logger import Logger


class NonLogger(Logger):
    def setup(self, context):
        pass

    def save_context(self, context, folder: str, iteration: int):
        pass

    def log(self, log_dict: dict):
        pass
