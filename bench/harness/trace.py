"""A traced window and what the benchmark reads from its Chrome trace.

``read_trace`` extends ``trace_device_time`` of ``chip_smoke.py`` (commit
a9c3ea2): every kernel, memcpy and memset with its interval, and the device
time of the kernels launched inside each named ``record_function`` range,
found by the CUDA API call that carries the kernel's correlation id. The
copy looks ranges up name by name, so a kernel counts in every range that
holds its launch (the harness's ``bench.prefill`` and the program's
``attention`` inside it), where the original counted only the innermost.

The device's busy time is the union of those intervals over one traced
window, and the window's length is taken around the same window, so the
idle share comes from one run (the smoke took its wall from another).

A traced run records two stretches one after the other (``Stretches``):
the first with the device tracer alone, which costs the host little, for
the kernels, the busy and idle time and the work done; the second with the
host's events too, for the named ranges (recording every host operation
slows a host-bound loop, so its idle time reads high).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the ranges the traced runs read: the harness's own and the program's
SPANS = ("bench.prefill", "bench.decode_step", "bench.pass", "bench.step", "attention", "mamba",
         "moe.route", "moe.gather_scatter", "moe.experts", "optimizer",
         "flash.backward", "cross_entropy")


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]     # (name, start us, duration us)
    span_ms: Dict[str, float]                   # device ms launched inside each range
    span_count: Dict[str, int]                  # ranges of each name
    busy_s: float                               # union of device intervals
    window_s: float                             # the traced window, host clock
    gaps: List[Tuple[str, float]]               # idle seconds by what the host ran

    def kernel_s(self, pred=lambda name: True) -> float:
        return sum(d for n, _, d in self.kernels if pred(n)) / 1e6

    def kernel_count(self, pred) -> int:
        return sum(1 for n, _, _ in self.kernels if pred(n))

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for name, _, dur in self.kernels:
            by[name] = by.get(name, 0.0) + dur / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the gaps between covered runs) of [start, end) us."""
    covered, gaps = 0.0, []
    cur0 = cur1 = None
    for a, b in sorted(intervals):
        if cur1 is None or a > cur1:
            if cur1 is not None:
                covered += cur1 - cur0
                gaps.append((cur1, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        covered += cur1 - cur0
    return covered, gaps


def read_trace(path, span_names, window_s: float) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, ranges, kernels, host = {}, {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            kernels.append((e["name"], float(e["ts"]), float(e["dur"]),
                            e.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], e["ts"])
        elif cat == "user_annotation" and e["name"] in span_names:
            ranges.setdefault(e["name"], {}).setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
        if cat in ("user_annotation", "cpu_op", "python_function", "cuda_runtime"):
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    span_ms: Dict[str, float] = {}
    span_count = {name: sum(len(r) for r in by_tid.values()) for name, by_tid in ranges.items()}
    starts = {name: {tid: [r[0] for r in sorted(rs)] for tid, rs in by_tid.items()}
              for name, by_tid in ranges.items()}
    for by_tid in ranges.values():
        for rs in by_tid.values():
            rs.sort()
    for _, _, dur, corr in kernels:
        tid, ts = launches.get(corr, (None, None))
        if tid is None:
            continue
        for name, by_tid in ranges.items():
            rs = by_tid.get(tid)
            if not rs:
                continue
            i = bisect.bisect_right(starts[name][tid], ts) - 1
            if i >= 0 and ts <= rs[i][1]:
                span_ms[name] = span_ms.get(name, 0.0) + dur / 1e3
    busy_us, gaps = _union([(ts, ts + dur) for _, ts, dur, _ in kernels])
    return Trace(kernels=[(n, ts, dur) for n, ts, dur, _ in kernels], span_ms=span_ms,
                 span_count=span_count, busy_s=busy_us / 1e6, window_s=window_s,
                 gaps=_label_gaps(gaps, host))


def _label_gaps(gaps, host, n: int = 10) -> List[Tuple[str, float]]:
    """Idle seconds summed by the innermost host event running at each
    gap's middle (the shortest one that covers it), the ``n`` largest."""
    host.sort()
    starts = [h[0] for h in host]
    by: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        best = None
        i = bisect.bisect_right(starts, mid) - 1
        # host events are short; look back over the ones that start before
        # the middle until one is found that covers it
        for j in range(i, max(-1, i - 200), -1):
            h0, h1, name = host[j]
            if h1 >= mid and (best is None or h1 - h0 < best[1] - best[0]):
                best = (h0, h1, name)
        label = best[2] if best else "no host event"
        by[label] = by.get(label, 0.0) + (b - a) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]


class Window:
    """A profiled window opened and closed at points the harness picks:
    ``start()`` and ``stop()`` each synchronise the device, so the trace
    holds exactly the work launched between them. ``host`` records the
    host's operations and ranges besides the device's."""

    def __init__(self, device, trace_path: Path, host: bool = True):
        self.device = device
        self.path = Path(trace_path)
        self.host = host
        self.prof = None
        self.t0 = self.t1 = None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _activities(self):
        from torch.profiler import ProfilerActivity

        if self.device.type != "cuda":
            return [ProfilerActivity.CPU]
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA] if self.host \
            else [ProfilerActivity.CUDA]

    def prime(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the device tracer, which takes seconds."""
        from torch.profiler import profile

        with profile(activities=self._activities()):
            self._sync()

    def start(self) -> None:
        from torch.profiler import profile

        self.prof = profile(activities=self._activities())
        self._sync()
        self.prof.start()
        self._sync()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Close the window and write its trace at once: a later profiler
        session in the process clears what this one recorded."""
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))

    @property
    def open(self) -> bool:
        return self.prof is not None and self.t1 is None

    def read(self) -> Optional[Trace]:
        if self.prof is None or self.t1 is None:
            return None
        try:
            return read_trace(self.path, set(SPANS), self.t1 - self.t0)
        finally:
            self.path.unlink()


class Stretches:
    """The traced stretches of a run, one after the other: the device's
    alone, then with the host's events. A kind calls ``step`` at each of its
    units (a decode step, a pass, a training step) and ``record``s what a
    unit did while a stretch is open."""

    def __init__(self, device, path: Path, on: bool):
        path = Path(path)
        self.windows = [Window(device, path.with_suffix(".device.json"), host=False),
                        Window(device, path.with_suffix(".host.json"), host=True)] if on else []
        if on:
            self.windows[1].prime()
        self.i = 0
        self.units = 0
        self.calls: List[Dict] = [{} for _ in self.windows]

    @property
    def current(self) -> Optional[Window]:
        return self.windows[self.i] if self.i < len(self.windows) else None

    def open(self) -> bool:
        return self.current is not None and self.current.open

    def record(self, key: str, value) -> None:
        if self.open():
            self.calls[self.i].setdefault(key, []).append(value)

    def step(self, start: bool, seconds: Optional[float] = None,
             units: Optional[int] = None) -> None:
        """At a unit's boundary: open the first stretch where ``start``;
        close the open one once it has lasted ``seconds`` or ``units``
        units, and open the next."""
        w = self.current
        if w is None:
            return
        if w.prof is None:
            if start:
                w.start()
                self.units = 0
            return
        self.units += 1
        if (seconds is not None and time.perf_counter() - w.t0 >= seconds) or \
                (units is not None and self.units >= units):
            w.stop()
            self.i += 1
            if self.current is not None:
                self.current.start()
                self.units = 0

    def close(self) -> None:
        if self.open():
            self.current.stop()
        self.i = len(self.windows)

    def reading(self) -> Dict:
        """{"trace", "calls"} of the device's stretch and {"spans",
        "span_calls"} of the host's (None where a stretch never ran)."""
        if not self.windows:
            return {}
        return {"trace": self.windows[0].read(), "calls": self.calls[0],
                "spans": self.windows[1].read(), "span_calls": self.calls[1]}
