"""Named profiler ranges over the port's layers, kernels and optimizer."""
from __future__ import annotations

import contextlib

import torch


def span(name: str):
    """A named range for ``torch.profiler`` (its device time is the time of
    the kernels launched inside it); nothing while no profiler runs, so the
    serving path pays a flag check, not a profiler call."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
