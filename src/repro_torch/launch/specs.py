"""Abstract input specs for every (arch x shape) cell (the port of
``repro.launch.specs``): meta-device tensors, which carry a shape and a
dtype and allocate nothing.

``abstract_params`` and ``abstract_cache`` run the port's own ``Model.init``
and ``init_cache`` on the meta device (``layers.normal`` draws nothing
there), so their trees are the real ones, leaf for leaf.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import torch

from repro_torch.hw.gpu_h100 import HBM_BYTES

META = torch.device("meta")

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# the production mesh's device count (launch/mesh.PRODUCTION_SHAPES, one pod)
PRODUCTION_DEVICES = 256


def shape_applicable(cfg, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: O(s^2) — long_500k skipped (DESIGN §4)"
    return True, ""


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (the ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg, batch: int, seq: int) -> Dict[str, Any]:
    b: Dict[str, Any] = {
        "tokens": sds((batch, seq), torch.int32),
        "labels": sds((batch, seq), torch.int32),
    }
    if cfg.frontend == "audio":
        b["frames"] = sds((batch, cfg.n_frontend_tokens, cfg.d_model),
                          cfg.torch_compute_dtype())
    if cfg.frontend == "vision":
        b["patches"] = sds((batch, cfg.n_frontend_tokens, cfg.d_model),
                           cfg.torch_compute_dtype())
    return b


def infer_batch_specs(cfg, batch: int, seq: int) -> Dict[str, Any]:
    b = batch_specs(cfg, batch, seq)
    b.pop("labels")
    return b


class _MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which torch
    does not have; ``layers.normal`` reads only its device there."""

    device = META


def _on_meta(model):
    meta = copy.copy(model)
    meta.device = META
    return meta


def abstract_params(model):
    """``model.init``'s tree of meta tensors."""
    return _on_meta(model).init(_MetaGenerator())


def abstract_cache(model, batch: int, cap: int):
    """``model.init_cache(batch, cap)``'s tree of meta tensors."""
    return _on_meta(model).init_cache(batch, cap)


def decode_specs(cfg, batch: int, cap: int) -> Dict[str, Any]:
    return {
        "tokens": sds((batch,), torch.int32),
        "pos": sds((), torch.int32),
    }


def recommended_state_dtype(cfg, hbm_bytes: int = HBM_BYTES,
                            n_devices: int = PRODUCTION_DEVICES) -> str:
    """f32 moments unless the arch cannot fit them on ``n_devices`` cards
    of ``hbm_bytes`` each (the reference's rule: parameters in bf16 and both
    moments within 30% of the memory, else bf16 moments within 40%, else
    int8). The defaults are the H100's 80 GiB and the production mesh's 256
    devices."""
    n = cfg.param_count()
    if n * (2 + 8) / n_devices < 0.30 * hbm_bytes:
        return "float32"
    if n * (2 + 4) / n_devices < 0.40 * hbm_bytes:
        return "bfloat16"
    return "int8"
