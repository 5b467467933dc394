"""Readings for the limits of ``correct``: the program's compared numbers
over many seeds, and the control's, in one process.

    python -m h100_bench.calibrate --workload <name> --seeds 1 2 3 ... \
        --seconds <s> [--control f32|tf32|fp8] [--out <file.jsonl>]

Each seed builds the cell's driver, runs a window of ``--seconds`` (long
enough to complete the mix's requests or the followed steps), releases the
program and prints one JSON line: the compared numbers, and with
``--control`` the same numbers of the reference computed at that
precision in the program's place (tf32 for a float32 cell, fp8 for a
bfloat16 one). The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import torch

from . import harness


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", choices=("tf32", "fp8"))
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    config = harness.load_config(cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    device = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.time()
        workdir = tempfile.mkdtemp(prefix="h100_bench-")
        driver = harness.load_driver(traffic["driver"]).Driver(config, traffic, seed, device,
                                                                workdir)
        try:
            driver.setup()
            stats = driver.run(args.seconds, None, lambda: None)
            driver.release()
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        row = {"workload": args.workload, "seed": seed, "checks": driver.check(),
               "readings": getattr(driver, "readings", {}),
               "e2e": stats["e2e"], "attempted": stats["attempted"], "failed": stats["failed"]}
        if args.control:
            row["control"] = {"precision": args.control, "checks": driver.control(args.control)}
        row["seconds"] = time.time() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del driver
        torch.cuda.empty_cache()
    print(f"forbidden modules: {harness.forbidden_modules()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
