"""LR schedules (functions of the step counter)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at ``total``. ``step`` is a 0-dim tensor (the optimizer's
    counter: the result is an f32 tensor on its device, computed as the
    reference computes it) or a number."""
    if not torch.is_tensor(step):
        step = torch.tensor(float(step))
    s = step.float()
    warm = torch.clamp(s / max(1, warmup), max=1.0)
    prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
