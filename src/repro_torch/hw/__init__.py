"""Hardware targets and device selection for the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default everywhere)
    raises when no card is present: the port never falls back to the CPU
    unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# the targets the port's tuner and schedule store know, by record name
TARGET_NAMES = ("gpu_h100",)


def get_target(name: str):
    """The port's ``HardwareTarget`` named ``name`` (a record's ``target``)."""
    from repro_torch.hw.gpu_h100 import GPU_H100

    if name != GPU_H100.name:
        raise KeyError(f"unknown target {name!r}; have {list(TARGET_NAMES)}")
    return GPU_H100
