"""Per-phase wall-clock timing, ported from
segmentation_pipeline_tpu/utils/timer.py, and the port's spans and
counters on the profiler's clock.

``Timer`` keeps named splits of one iteration: ``stamp(name,
sync_on=tensor)`` closes a split at a stamp (first waiting for the
tensor's device: ``torch.cuda.synchronize`` on the card, nothing on the
CPU); ``phase(key, name)`` times one block into ``key`` through the span
``name``.

``span(name, wait=False, **attrs)`` and ``count(name, key, n=1)`` record
only while torch's profiler records (``torch.profiler.profile`` or
``ProfilerTrace``); otherwise they cost one flag check. A span recorded
there is a ``record_function`` range on the profiler's timeline, beside the
kernels launched inside it, and an in-memory record (``recorded()``): its
name, start and end (``time.perf_counter_ns``), thread, parent (the
innermost recorded span open on its thread), request (the id of the
outermost one, shared by every span of one iteration or one request),
``wait`` (True where the host waits for the device) and attributes.
``host_ms`` is a span's duration less its waits. ``reset()`` clears the
records; a span entered while the profiler records is closed normally even
if the profiler stops first.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List

import torch

# the most span records kept until ``reset()``; later ones are counted as
# dropped
MAX_SPANS = 200_000

_profiling = torch._C._autograd._profiler_enabled
_ids = itertools.count(1)
_open = threading.local()
_lock = threading.Lock()
_spans: List["SpanRecord"] = []
_counters: Dict[str, collections.Counter] = {}
_dropped = 0


class SpanRecord:
    """One recorded span; ``end_ns`` is None while it is open."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "thread", "parent", "request",
                 "wait", "attrs")

    def __init__(self, name, wait, attrs, parent):
        self.id = next(_ids)
        self.name, self.wait, self.attrs = name, wait, attrs
        self.thread = threading.get_ident()
        self.parent = None if parent is None else parent.id
        self.request = self.id if parent is None else parent.request
        self.start_ns = time.perf_counter_ns()
        self.end_ns = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __repr__(self):
        return f"SpanRecord({self.name!r}, id={self.id}, parent={self.parent}, wait={self.wait})"


class span:
    """Context manager: a span named ``name`` while the profiler records
    (see the module's docstring), nothing otherwise."""

    __slots__ = ("name", "wait", "attrs", "_record", "_range", "_stack")

    def __init__(self, name: str, wait: bool = False, **attrs):
        self.name, self.wait, self.attrs = name, wait, attrs
        self._record = None

    def __enter__(self):
        if not _profiling():
            return self
        global _dropped
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        record = SpanRecord(self.name, self.wait, self.attrs, stack[-1] if stack else None)
        if len(_spans) < MAX_SPANS:
            _spans.append(record)
        else:
            _dropped += 1
        stack.append(record)
        self._record, self._stack = record, stack
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        record = self._record
        if record is None:
            return False
        self._range.__exit__(*exc)
        record.end_ns = time.perf_counter_ns()
        self._stack.remove(record)
        self._record = self._range = self._stack = None
        return False


def count(name: str, key, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` under ``key`` while the profiler
    records."""
    if not _profiling():
        return
    with _lock:
        counter = _counters.get(name)
        if counter is None:
            counter = _counters[name] = collections.Counter()
        counter[key] += n


def recorded() -> dict:
    """The closed spans in the order they opened, the counters, and the
    number of spans dropped past ``MAX_SPANS``."""
    with _lock:
        counters = {name: collections.Counter(c) for name, c in _counters.items()}
    return {"spans": [s for s in _spans if s.end_ns is not None],
            "counters": counters, "dropped": _dropped}


def reset() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0


def host_ms(record: SpanRecord, spans: List[SpanRecord]) -> float:
    """``record``'s duration in ms less the durations of its ``wait``
    descendants among ``spans`` (the outermost ones: a wait inside a wait
    is not taken twice)."""
    children = collections.defaultdict(list)
    for s in spans:
        if s.request == record.request and s.parent is not None:
            children[s.parent].append(s)
    waited, below = 0, list(children[record.id])
    while below:
        s = below.pop()
        if s.wait:
            waited += s.end_ns - s.start_ns
        else:
            below.extend(children[s.id])
    return (record.end_ns - record.start_ns - waited) / 1e6


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

    @contextlib.contextmanager
    def phase(self, key: str, name: str, wait: bool = False, **attrs):
        """Time the block into ``key`` (seconds, summed over the calls
        since ``start``) inside ``span(name, wait, **attrs)``."""
        start = time.perf_counter()
        try:
            with span(name, wait, **attrs):
                yield
        finally:
            self.timestamps[key] = self.timestamps.get(key, 0.0) + time.perf_counter() - start


class ProfilerTrace:
    """Context manager: a torch.profiler trace of the block (the host, and
    the card's kernels where CUDA is available), written on exit into
    ``log_dir`` as a ``*.pt.trace.json`` file that TensorBoard's profiler
    plugin and chrome://tracing read; the counterpart of the JAX package's
    jax.profiler trace. The port's spans (``span``) appear in it as
    ``user_annotation`` ranges."""

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
