"""Ground-truth timing of one matmul schedule (the AutoTVM role), on the card.

The counterpart of the reference's ``benchmarks/measure.py``: there a config
is realised as an XLA ``fori_loop`` of block dots timed on the host CPU;
here it is the hand-written Hopper kernel itself, launched with the
config's (bm, bn, bk, double_buffer) and timed with CUDA events. Tuna never
ranks by these times; they only say how good the static ranking was.

On a CPU tensor the same call times the plain version with the host clock
(for the tests of this plumbing: such a time says nothing about the card).
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict

import torch

from repro_torch.kernels import matmul as kmatmul


def time_fn(fn: Callable[[], object], device: torch.device, warmup: int = 3,
            iters: int = 10) -> float:
    """Median seconds per call of ``fn`` after ``warmup`` calls. On a card
    each call sits between its own pair of CUDA events, all enqueued back
    to back and read after one synchronise."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize(device)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in events) / 1e3


def measure_config(a: torch.Tensor, b: torch.Tensor, cfg: Dict,
                   warmup: int = 3, iters: int = 10) -> float:
    """Median seconds of ``A @ B`` with the kernel at schedule ``cfg``."""
    return time_fn(
        lambda: kmatmul.matmul(a, b, bm=cfg["bm"], bn=cfg["bn"], bk=cfg["bk"],
                               double_buffer=cfg["double_buffer"]),
        a.device, warmup=warmup, iters=iters)
