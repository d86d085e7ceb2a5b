"""Device time of one call by CUDA-graph replay: a frozen copy of
``time_fn`` in ``src/repro_torch/benchmarks/measure.py`` (commit a9c3ea2),
card path only. The warm-up runs eagerly on a side stream, ``iters`` calls
are captured in one graph, and the median of ``reps`` replays, each between
its own pair of CUDA events, over ``iters`` is the time: the host's work
per call stays out of it.
"""
from __future__ import annotations

import statistics
from typing import Callable

import torch


def replay_seconds(fn: Callable[[], object], device: torch.device, warmup: int = 3,
                   iters: int = 10, reps: int = 5) -> float:
    if device.type != "cuda":
        raise RuntimeError("graph replay times a CUDA card only")
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize(device)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in events) / iters / 1e3
