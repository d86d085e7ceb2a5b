"""Background-prefetching loader with straggler instrumentation (the port's
copy of ``repro.data.loader``).

A worker thread keeps ``depth`` batches ahead of the consumer; fetch latency
per step is recorded so the runtime straggler monitor (runtime/straggler.py)
can flag slow input shards. ``skip_to(step)`` supports bit-exact restart.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional

import numpy as np


class PrefetchLoader:
    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next_fetch = start_step
        self._stop = threading.Event()
        self.fetch_seconds: Dict[int, float] = {}
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            step = self._next_fetch
            t0 = time.perf_counter()
            batch = self.source.batch(step)
            self.fetch_seconds[step] = time.perf_counter() - t0
            self._next_fetch = step + 1
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self, expected_step: Optional[int] = None):
        step, batch = self._q.get()
        if expected_step is not None and step != expected_step:
            # restart path: drain until aligned (source is random-access)
            while step < expected_step:
                step, batch = self._q.get()
            if step != expected_step:
                batch = self.source.batch(expected_step)
                step = expected_step
        return step, batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
