"""Per-phase wall-clock timing with device synchronization, ported from
segmentation_pipeline_tpu/utils/timer.py: ``stamp(sync_on=tensor)`` first
waits for the tensor's device (``torch.cuda.synchronize`` on the card,
nothing on the CPU), so asynchronous launches do not hide device time; and
``ProfilerTrace``, a torch.profiler trace of a block written to a folder."""
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


class ProfilerTrace:
    """Context manager: a torch.profiler trace of the block (the host, and
    the card's kernels where CUDA is available), written on exit into
    ``log_dir`` as a ``*.pt.trace.json`` file that TensorBoard's profiler
    plugin and chrome://tracing read; the counterpart of the JAX package's
    jax.profiler trace."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.profile = None

    def __enter__(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(self.log_dir)))
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        self.profile.__exit__(*exc)
        return False
