"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a steady
stretch of the window, the port's kernel launch counters over the same
stretch, and the reduction of the profiler's trace to what the per-layer
readers and the result's ``breakdown`` need.

The trace is exported as a Chrome trace into the run's scratch directory,
read once and deleted. Device intervals (kernels, copies, fills) are merged
into the busy time; each kernel is tied by its correlation id to the host
launch, and through it to the benchmark's ``record_function`` span that
was open on that thread when it was launched.
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the idle gaps given a label, longest first
LABELLED_GAPS = 2000


def launch_counts() -> Dict[str, collections.Counter]:
    """The port's hand-kernel launches by shape since the last reset."""
    from segmentation_pipeline_torch.ops import conv3x3

    return {"fwd": collections.Counter(conv3x3.conv3x3_s1p1.launches_by_shape),
            "dx": collections.Counter(conv3x3.conv3x3_s1p1_dx.launches_by_shape),
            "dw": collections.Counter(conv3x3.conv3x3_s1p1_dw.launches_by_shape)}


def reset_launch_counts() -> None:
    from segmentation_pipeline_torch.ops import conv3x3

    conv3x3.reset_launch_counts()


class Tracer:
    """Start and stop once; ``summary`` is the reduced trace."""

    def __init__(self, workdir: str, device: torch.device):
        self.workdir = workdir
        self.device = device
        self.summary: Optional[dict] = None
        self._profiler = None

    @property
    def active(self) -> bool:
        return self._profiler is not None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        reset_launch_counts()
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        window_s = time.perf_counter() - self._t0
        counts = launch_counts()
        self._profiler.stop()
        path = os.path.join(self.workdir, "trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.summary = summarize(events, window_s)
        self.summary["counts"] = counts


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: List[dict], window_s: float) -> dict:
    """busy_s (the union of device intervals), the device time of every
    kernel name, the device time of the kernels launched inside each of
    the benchmark's ``bench.*`` spans, and the idle gaps between device
    intervals by the host operation under each gap's middle."""
    device, host_ops, spans, launches = [], [], collections.defaultdict(list), {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATEGORIES:
            device.append(e)
        elif cat == "user_annotation" and e["name"].startswith("bench."):
            spans[e["tid"]].append((ts, ts + dur, e["name"]))
        elif cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], ts)
        if cat in ("cpu_op", "user_annotation", "cuda_runtime"):
            host_ops.append((ts, ts + dur, e["name"]))

    kernel_s = collections.Counter()
    span_s = collections.Counter()
    for e in device:
        seconds = float(e["dur"]) * 1e-6
        kernel_s[e["name"]] += seconds
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        tid, ts = launch
        for a, b, name in spans.get(tid, ()):
            if a <= ts <= b:
                span_s[name] += seconds

    merged = _merge((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps = collections.Counter()
    starts = np.array([h[0] for h in host_ops])
    ends = np.array([h[1] for h in host_ops])
    between = sorted(((nxt - end, (end + nxt) / 2) for (_, end), (nxt, _)
                      in zip(merged, merged[1:])), reverse=True)[:LABELLED_GAPS]
    for length, mid in between:
        under = np.flatnonzero((starts <= mid) & (ends >= mid))
        label = host_ops[under[np.argmin(ends[under] - starts[under])]][2] \
            if len(under) else "no host op"
        gaps[label] += length * 1e-6
    return {"busy_s": busy_s, "window_s": window_s, "kernel_s": dict(kernel_s),
            "span_s": dict(span_s), "idle_gaps": gaps.most_common(10),
            "device_ops": kernel_s.most_common(10)}


def device_seconds(summary: dict, pattern, exclude=None) -> float:
    """The device time of the kernels whose names match ``pattern`` and not
    ``exclude``."""
    return sum(s for name, s in summary["kernel_s"].items()
               if pattern.search(name) and not (exclude and exclude.search(name)))
