"""The closed loop of a pair cell: request i is sent once request i - 1 is
done, from the window's start until its deadline; the request under way at
the deadline finishes and counts, and so does its time. On several ranks
rank 0's clock decides, through ``agree`` (a broadcast of rank 0's
``(go, trace command)``)."""

from __future__ import annotations

import time
from typing import Callable, List, Tuple


def closed_loop(run, request: Callable[[int], int],
                agree: Callable[[Tuple[bool, int]], Tuple[bool, int]] = lambda c: c,
                ) -> Tuple[List[float], List[int], float]:
    """(latency of each request, its solver iterations, the window's
    seconds); ``request(i)`` returns request i's iterations once its
    answer is complete."""
    tracer = run.tracer
    tracer.begin_window(run.seconds)
    start = time.perf_counter()
    deadline = start + run.seconds
    latencies, iterations, i = [], [], 0
    while True:
        go = i == 0 or time.perf_counter() < deadline
        go, command = agree((go, tracer.decide() if go else 0))
        if not go:
            break
        tracer.apply(command, i)
        t0 = time.perf_counter()
        iterations.append(request(i))
        latencies.append(time.perf_counter() - t0)
        i += 1
    tracer.close(i)
    return latencies, iterations, time.perf_counter() - start
