"""The closed loop the serving drivers share: one client sends the next
request as the last one returns, for the window's length, on a fixed
order of requests drawn from the seed.

Each request's latency is the host clock from its send to its answer,
which the entry fetches to the host (the answer's fetch synchronizes with
the card). A request that raises counts as failed. A sample of the
answers, drawn from the seed (reservoir sampling over the requests that
the window completes), is kept for the comparison after the window.
"""
from __future__ import annotations

import time
from typing import Callable, List

import numpy as np
import torch


def request_order(seed: int, pool: int, per_request: int, count: int) -> List[List[int]]:
    """``count`` requests of ``per_request`` pool indices each: the pool
    shuffled again whenever it runs out, so every seed sends the same
    subjects equally often, in its own order."""
    rng = np.random.default_rng(seed)
    order, out = [], []
    while len(out) < count:
        while len(order) < per_request:
            order += list(rng.permutation(pool))
        out.append([int(i) for i in order[:per_request]])
        order = order[per_request:]
    return out


def closed_loop(send: Callable, requests: List[List[int]], seconds: float, device,
                tracer=None, trace_requests: int = 0, keep: int = 4, seed: int = 0,
                window_opens: Callable = None) -> dict:
    """``send(indices)`` answers one request. Returns the latencies (s), the
    kept answers [(request, indices, answer)], the counts and, when
    traced, the requests inside the traced stretch (the window's first
    ``trace_requests``)."""
    rng = np.random.default_rng([seed, 1])
    kept, latencies, failed = [], [], 0
    if window_opens is not None:
        window_opens()
    t0 = time.perf_counter()
    k = 0
    traced = 0
    while True:
        if tracer is not None and k == 0:
            tracer.start()
        indices = requests[k % len(requests)]
        sent = time.perf_counter()
        try:
            answer = send(indices)
        except Exception as error:  # noqa: BLE001 - a failed request is counted, not fatal
            print(f"request {k} failed: {error!r}", flush=True)
            failed += 1
            answer = None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        done = time.perf_counter()
        latencies.append(done - sent)
        k += 1
        if answer is not None:
            if len(kept) < keep:
                kept.append((k - 1, indices, answer))
            else:
                j = int(rng.integers(0, k))
                if j < keep:
                    kept[j] = (k - 1, indices, answer)
        if tracer is not None and tracer.active and k == trace_requests:
            tracer.stop()
            traced = k
        if done - t0 >= seconds and (tracer is None or not tracer.active):
            break
    return {"latencies": latencies, "elapsed": done - t0, "kept": kept, "attempted": k,
            "failed": failed, "traced": traced}
