"""Start the ranks of a data-parallel mesh and run a module in each.

Ported from research/scripts/launch_multihost.py. The JAX package runs one
process per host, which drives every local device; the port runs one
process per device, joined by ``torch.distributed``, and
``parallel.mesh.make_mesh()`` then spans the process group.

With ``--coordinator`` this process is one rank of a group that other
launches join (one per device, on any host):

    python -m segmentation_pipeline_torch.research.scripts.launch_multihost \\
        --coordinator 10.0.0.2:8476 --num-processes 4 --process-id 0 \\
        -- segmentation_pipeline_torch.research.dmri_hippo.run main <dataset> <logs>

Without it, the launcher starts one process per local card itself
(``--num-processes`` overrides the count, e.g. for CPU ranks under gloo),
with the ``spawn`` start method (CUDA cannot be used in a forked child),
joins them through a rendezvous file in a temporary folder, and waits for
them. Unless ``OMP_NUM_THREADS`` is set, each of its ranks takes an equal
share of the host's cores for PyTorch's CPU threads, as torchrun does:
ranks that each take all of them oversubscribe the cores and wait on each
other's threads. If a rank fails, the others
are stopped and the launcher exits with an error; it leaves no process
running.

The backend is NCCL where there is a card and gloo on the CPU, unless
``--backend`` says otherwise. Each rank sets ``LOCAL_RANK`` (the launcher's
own ranks) or reads it from the environment; ``make_mesh`` puts the rank on
``cuda:LOCAL_RANK``.
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys
import tempfile
import time
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's rendezvous (this process is one rank)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="ranks in the group (default: the local cards, or 1)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank (with --coordinator)")
    parser.add_argument("--backend", default=None,
                        help="torch.distributed backend (default: nccl with a card, else gloo)")
    parser.add_argument("--timeout", type=float, default=1800.0,
                        help="seconds a collective may wait for the other ranks")
    parser.add_argument("module_and_args", nargs=argparse.REMAINDER,
                        help="-- <module> <args...>")
    return parser


def run_rank(rank: int, init_method: str, world_size: int, backend: str, timeout: float,
             module: str, module_args, local: bool = False):
    """Join the process group as ``rank`` and run ``module`` as __main__
    with ``module_args``; the group is torn down when it returns. The
    launcher's own ranks (``local``) set ``LOCAL_RANK`` and share the
    host's cores."""
    if local:
        os.environ["LOCAL_RANK"] = str(rank)
        if "OMP_NUM_THREADS" not in os.environ:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    if torch.cuda.is_available():
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=timeout))
    try:
        print(f"process {rank}/{world_size}: backend {backend}", flush=True)
        sys.argv = [module] + list(module_args)
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        dist.destroy_process_group()


def _stop(processes):
    for p in processes:
        if p.is_alive():
            p.terminate()
    for p in processes:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def spawn_ranks(n: int, target, args=(), join_timeout: Optional[float] = None):
    """``target(rank, *args)`` in ``n`` processes started with the spawn
    method (CUDA cannot be used in a forked child). Returns when all have
    exited with 0; otherwise raises ``SystemExit`` naming the first rank
    that failed, or that still ran after ``join_timeout`` seconds, and
    stops the others. No process outlives the call."""
    ctx = mp.get_context("spawn")
    processes = [ctx.Process(target=target, args=(r, *args)) for r in range(n)]
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    failed = []
    try:
        for p in processes:
            p.start()
        while any(p.is_alive() for p in processes):
            # read before the others are stopped: their codes would be ours
            failed = [f"rank {r} of {n} exited with code {p.exitcode}"
                      for r, p in enumerate(processes) if p.exitcode not in (None, 0)]
            if not failed and deadline is not None and time.monotonic() > deadline:
                failed = [f"rank {r} of {n} still ran after {join_timeout:g} s"
                          for r, p in enumerate(processes) if p.is_alive()]
            if failed:
                break
            time.sleep(0.2)
        else:
            failed = [f"rank {r} of {n} exited with code {p.exitcode}"
                      for r, p in enumerate(processes) if p.exitcode != 0]
    finally:
        _stop(processes)
    if failed:
        raise SystemExit(failed[0])


def launch_local(n: int, backend: str, timeout: float, module: str, module_args,
                 join_timeout: Optional[float] = None):
    """``n`` spawned ranks on this host, joined through a rendezvous file,
    each running ``module``; returns when all have exited with 0
    (``spawn_ranks`` says how it fails)."""
    with tempfile.TemporaryDirectory() as folder:
        init = f"file://{os.path.join(folder, 'rendezvous')}"
        spawn_ranks(n, run_rank, (init, n, backend, timeout, module, module_args, True),
                    join_timeout)


def main(argv=None):
    args = build_parser().parse_args(argv)
    rest = [a for a in args.module_and_args if a != "--"]
    if not rest:
        raise SystemExit("no target module given")
    module, module_args = rest[0], rest[1:]
    backend = args.backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            raise SystemExit("--coordinator needs --num-processes and --process-id")
        run_rank(args.process_id, f"tcp://{args.coordinator}", args.num_processes, backend,
                 args.timeout, module, module_args)
    else:
        n = args.num_processes or max(1, torch.cuda.device_count())
        launch_local(n, backend, args.timeout, module, module_args)


if __name__ == "__main__":
    main()
