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


# the targets the port's tuner and schedule store know, by record name: the
# port's Hopper target, the default wherever a target is not named, then the
# reference's three (own copies of ``repro.hw``), so records of either
# package featurize and score on either side
DEFAULT_TARGET = "gpu_h100"
TARGET_NAMES = (DEFAULT_TARGET, "tpu_v5e", "cpu_avx2", "gpu_a100")


def get_target(name: str):
    """The port's ``HardwareTarget`` named ``name`` (a record's ``target``)."""
    from repro_torch.hw.cpu_avx2 import CPU_AVX2
    from repro_torch.hw.gpu_a100 import GPU_A100
    from repro_torch.hw.gpu_h100 import GPU_H100
    from repro_torch.hw.tpu_v5e import TPU_V5E

    targets = {t.name: t for t in (GPU_H100, TPU_V5E, CPU_AVX2, GPU_A100)}
    try:
        return targets[name]
    except KeyError:
        raise KeyError(f"unknown target {name!r}; have {list(TARGET_NAMES)}") from None
