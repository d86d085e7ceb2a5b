"""Failure injection + restart policy for the training loop (the port's copy
of ``repro.runtime.failure``).

``FailureInjector`` raises ``InjectedFailure`` at configured steps (tests and
chaos drills); ``RestartPolicy`` drives the train loop's recover-from-latest-
checkpoint behaviour with bounded retries — the single-process analogue of a
cluster scheduler rescheduling a died pod.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Set


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: Set[int] = dataclasses.field(default_factory=set)
    fail_during_save_at: Set[int] = dataclasses.field(default_factory=set)
    _fired: Set[int] = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int, phase: str = "step") -> None:
        target = (
            self.fail_during_save_at if phase == "save" else self.fail_at_steps
        )
        if step in target and (step, phase) not in self._fired:
            self._fired.add((step, phase))
            raise InjectedFailure(f"injected failure at step {step} ({phase})")


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 3
    backoff_seconds: float = 0.0
    restarts: int = 0

    def should_restart(self, exc: Exception) -> bool:
        if self.restarts >= self.max_restarts:
            return False
        self.restarts += 1
        if self.backoff_seconds:
            time.sleep(self.backoff_seconds * self.restarts)
        return True
