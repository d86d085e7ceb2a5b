"""Straggler detection: rolling step-time stats + mitigation hooks (the
port's copy of ``repro.runtime.straggler``).

At 1000+ nodes the common failure mode is not death but slowness (one host's
HBM throttling, a flaky NIC). The monitor keeps a rolling median of step
times; a step exceeding ``threshold × median`` raises a flag with a suggested
mitigation:

  * ``rebalance_data``  — input-bound (loader fetch time dominates)
  * ``exclude_and_remesh`` — persistent compute slowness (the elastic path:
     checkpoint → shrink mesh → restore: ``checkpoint/elastic.py``'s
     ``restore_on_mesh``, or ``reshard_live`` without the disk)
  * ``transient``       — one-off; log only

On a single host the signals are simulated in tests via an
injected sleep; the policy logic is what's exercised.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import Deque, List, Optional
from collections import deque


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_seconds: float
    median_seconds: float
    mitigation: str


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 32,
                 persistent_after: int = 3, min_seconds: float = 0.05):
        self.threshold = threshold
        self.window: Deque[float] = deque(maxlen=window)
        self.persistent_after = persistent_after
        self.min_seconds = min_seconds  # ignore micro-jitter on tiny steps
        self._consecutive_slow = 0
        self.events: List[StragglerEvent] = []

    def record(self, step: int, step_seconds: float,
               fetch_seconds: float = 0.0) -> Optional[StragglerEvent]:
        if len(self.window) >= 4:
            med = statistics.median(self.window)
            if step_seconds > max(self.threshold * med, self.min_seconds):
                self._consecutive_slow += 1
                if fetch_seconds > 0.5 * step_seconds:
                    mitigation = "rebalance_data"
                elif self._consecutive_slow >= self.persistent_after:
                    mitigation = "exclude_and_remesh"
                else:
                    mitigation = "transient"
                ev = StragglerEvent(step, step_seconds, med, mitigation)
                self.events.append(ev)
                self.window.append(step_seconds)
                return ev
        self._consecutive_slow = 0
        self.window.append(step_seconds)
        return None


class Heartbeat:
    """Liveness file the cluster supervisor polls (touch per step)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int) -> None:
        with open(self.path, "w") as f:
            f.write(f"{step} {time.time()}")
