"""Run one cell of the benchmark and print its result as the last line of
standard output:

    python -m h100_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (from a profiled stretch of the
window) and a breakdown of the device's time. The compared numbers and
their limits end standard error and the line. Exits non-zero, with no
result, when the cards are missing or when a forbidden module (JAX, flax,
optax, orbax or the JAX package) was loaded.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
# the library caches the program may use, inside the checkout at fixed paths
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_cache"}


def main(argv=None) -> int:
    import argparse
    import json

    for var, sub in CACHES.items():  # before torch loads
        os.environ[var] = str(_ROOT / "build" / sub)
    from h100_bench import harness

    started = harness.process_start_time()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              started)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(_ROOT))
    sys.exit(main())
