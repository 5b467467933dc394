"""Logger ABC, copied from segmentation_pipeline_tpu/loggers/logger.py:
setup / save_context / log / close."""
from __future__ import annotations

from abc import ABC, abstractmethod


class Logger(ABC):
    @abstractmethod
    def setup(self, context):
        ...

    @abstractmethod
    def save_context(self, context, folder: str, iteration: int):
        ...

    @abstractmethod
    def log(self, log_dict: dict):
        ...

    def close(self):
        """Drain any pending asynchronous work (checkpoint writes, open
        streams). The trainer calls this on every exit path so train()
        never returns with a checkpoint still mid-write. No-op by default."""
