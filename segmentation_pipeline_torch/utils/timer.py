"""Per-phase wall-clock timing with device synchronization, ported from
segmentation_pipeline_tpu/utils/timer.py: ``stamp(sync_on=tensor)`` first
waits for the tensor's device (``torch.cuda.synchronize`` on the card,
nothing on the CPU), so asynchronous launches do not hide device time."""
from __future__ import annotations

import time

import torch


class Timer:
    def __init__(self):
        self.timestamps = {}
        self._last = None

    def start(self):
        self.timestamps = {}
        self._last = time.time()

    def stamp(self, name: str, sync_on=None):
        if sync_on is not None and sync_on.device.type == "cuda":
            torch.cuda.synchronize(sync_on.device)
        now = time.time()
        self.timestamps[name] = self.timestamps.get(name, 0.0) + (now - self._last)
        self._last = now
