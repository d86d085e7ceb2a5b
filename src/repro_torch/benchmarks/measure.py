"""Ground-truth timing of one matmul schedule (the AutoTVM role), on the card.

The counterpart of the reference's ``benchmarks/measure.py``: there a config
is realised as an XLA ``fori_loop`` of block dots timed on the host CPU;
here it is the hand-written Hopper kernel itself, launched with the
config's (bm, bn, bk, double_buffer) and timed as device time: the calls
are captured in a CUDA graph whose replays are timed with CUDA events, so
the host's work per call (checks, tensor-map encodes, dispatch) stays out
of every config's time. Tuna never ranks by these times; they only say how
good the static ranking was.

On a CPU tensor the same call times the plain version with the host clock
(for the tests of this plumbing: such a time says nothing about the card).
A config of the reference's ``cpu`` kind (block sizes the kernel is not
built for, a loop ``order`` and ``unroll_i``) runs the plain version's K
loop at its ``bk``: the reference realises every knob as an XLA loop of
block dots, the port's plain version only the K slices, so on the CPU such
a time depends on ``bk`` alone.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict

import torch

from repro_torch.kernels import matmul as kmatmul


def time_fn(fn: Callable[[], object], device: torch.device, warmup: int = 3,
            iters: int = 10, reps: int = 5) -> float:
    """Median seconds per call of ``fn`` after ``warmup`` calls.

    On a card the warm-up runs eagerly on a side stream, then ``iters``
    calls are captured in one CUDA graph, which is replayed ``reps`` times,
    each replay between its own pair of CUDA events: the median replay over
    ``iters``. ``fn`` runs ``warmup + iters`` times on the host either way.
    On the CPU each of ``iters`` calls is timed with the host clock."""
    if device.type != "cuda":
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)
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


def measure_config(a: torch.Tensor, b: torch.Tensor, cfg: Dict,
                   warmup: int = 3, iters: int = 10) -> float:
    """Median seconds of ``A @ B`` with the kernel at schedule ``cfg`` (a
    ``cpu``-kind config: ``matmul.k_slices`` at its ``bk``, CPU tensors
    only)."""
    if "order" in cfg:
        if a.device.type != "cpu":
            raise ValueError(f"a cpu-kind config {cfg} has no kernel on "
                             f"{a.device}")
        return time_fn(lambda: kmatmul.k_slices(a, b, cfg["bk"]), a.device,
                       warmup=warmup, iters=iters)
    return time_fn(
        lambda: kmatmul.matmul(a, b, bm=cfg["bm"], bn=cfg["bn"], bk=cfg["bk"],
                               double_buffer=cfg["double_buffer"]),
        a.device, warmup=warmup, iters=iters)
