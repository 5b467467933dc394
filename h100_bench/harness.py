"""The benchmark's frame: it finds a cell's configuration, traffic mix,
limits, driver and per-layer readers by the names in ``BENCHMARK.json``,
runs the driver's set-up, window and comparison, and assembles the result
line.

Everything that belongs to one configuration, mix or metric is a file of
its own: ``configs/<config>.json``, ``traffic/<mix>.json`` (whose
``driver`` names ``drivers/<driver>.py``), ``limits/<workload>.json`` and
``metrics/<metric>.py``. A new cell, configuration or metric adds files and
entries and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no process of the benchmark may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "segmentation_pipeline_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(folder: str, name: str) -> dict:
    with open(BENCH / folder / f"{name}.json") as f:
        return json.load(f)


def find(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return _json("configs", name)


def load_traffic(name: str) -> dict:
    return _json("traffic", name)


def load_limits(workload: str) -> dict:
    return _json("limits", workload)


def load_driver(name: str):
    return importlib.import_module(f"h100_bench.drivers.{name}")


def load_metric(name: str):
    """``metrics/<name>.py`` (names hold dots, so by path): a module with
    ``read(ctx)`` that returns the metric's value or None."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(spec: dict, workload: str, kind: str) -> List[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark forbids."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def process_start_time() -> float:
    """The wall-clock time this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


def judge(checks: Dict[str, float], limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each compared number at or
    under its limit, and finite."""
    table, correct = {}, True
    for name, value in checks.items():
        limit = limits[name]["limit"]
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        table[name] = {"value": value, "limit": limit}
    missing = set(limits) - set(checks)
    for name in sorted(missing):
        table[name] = {"value": None, "limit": limits[name]["limit"]}
        correct = False
    return correct, table


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             started: float, device=None, overrides: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result line's object. ``device`` and
    ``overrides`` (config and traffic keys) are for tests on the CPU."""
    import torch

    from . import trace as tracing

    cell = find(spec["workloads"], workload, "workload")
    config = {**load_config(cell["config"]), **(overrides or {}).get("config", {})}
    traffic = {**load_traffic(cell["traffic"]), **(overrides or {}).get("traffic", {})}
    limits = load_limits(workload)
    device = torch.device(device or "cuda")
    workdir = tempfile.mkdtemp(prefix="h100_bench-")
    try:
        driver = load_driver(traffic["driver"]).Driver(config, traffic, seed, device, workdir)
        tracer = tracing.Tracer(workdir, device) if trace else None
        window = {}

        def window_opens():
            window["setup_s"] = time.time() - started

        driver.setup()
        stats = driver.run(seconds, tracer, window_opens)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        driver.release()
        checks = driver.check()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    correct, table = judge(checks, limits)
    if stats["failed"]:
        correct = False

    if trace:
        ctx = {"summary": tracer.summary, "work": stats["work"], "config": config,
               "traffic": traffic, "workload": workload}
        metrics = {}
        for m in metrics_of(spec, workload, "per_layer"):
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**stats["e2e"], "setup_s": window["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(spec, workload, "end_to_end")}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": stats["attempted"],
              "failed": stats["failed"], "metrics": metrics, "device": device_info}
    if trace:
        summary = tracer.summary
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in summary["device_ops"]],
                               "idle_gaps": [list(x) for x in summary["idle_gaps"]]}
    result["checks"] = table
    return result
