"""Step functions (the port of ``repro.launch.steps``), eager torch.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``. The reference's step is a pure function that XLA
compiles; here it runs eagerly, takes the gradients with
``torch.autograd.grad`` and updates the parameters and the optimizer state
in place (a second copy of yi-6b's parameters would not fit beside its
gradients and moments), returning the same trees.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel import collectives


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(
    model: Model,
    opt_cfg: adamw.AdamWConfig,
    *,
    accum_steps: int = 1,
    grad_compression: Optional[str] = None,  # None | "int8"
    schedule: Callable = warmup_cosine,
    grad_shardings=None,
    grad_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """With ``accum_steps > 1`` the batch's leading axis is split into that
    many microbatches, run one after another, their gradients summed in f32
    (or in ``grad_dtype``) and divided by ``accum_steps``, as are the
    metrics. ``grad_compression="int8"`` puts each gradient through the int8
    round trip before the optimizer. The LR schedule is applied to the
    optimizer's step counter. ``grad_shardings`` (a mesh's placement of the
    accumulator) waits for the multi-device slice (ROADMAP Queue A 8)."""
    if grad_shardings is not None:
        raise NotImplementedError("grad_shardings needs a device mesh, which the "
                                  "port does not have yet (ROADMAP Queue A 8)")
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")

    def value_and_grad(params, leaves, batch):
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        batch = _to_device(batch, model.device)
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if accum_steps == 1:
                metrics, grads = value_and_grad(params, leaves, batch)
            else:
                acc_dt = grad_dtype or torch.float32
                grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
                msum = None
                for i in range(accum_steps):
                    mb = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])[i]
                          for k, v in batch.items()}
                    m, g = value_and_grad(params, leaves, mb)
                    for acc, gi in zip(grads, g):
                        acc += gi.to(grad_dtype) if grad_dtype is not None else gi
                    del g
                    msum = m if msum is None else {k: msum[k] + m[k] for k in msum}
                grads = [g / accum_steps for g in grads]
                metrics = {k: v / accum_steps for k, v in msum.items()}
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = tree.unflatten_like(params, grads)
        if grad_compression == "int8":
            grads = collectives.int8_compress_decompress(grads)
        lr_scale = schedule(opt_state["step"])
        params, opt_state, om = adamw.apply_updates(opt_cfg, params, grads, opt_state,
                                                    lr_scale=lr_scale)
        metrics = dict(metrics)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model, cap: int) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, cap)

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One decode step for a whole batch of requests: (params, cache, tokens
    [B], pos) -> (logits, cache), the cache written in place."""

    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return serve_step
