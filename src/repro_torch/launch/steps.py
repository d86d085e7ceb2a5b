"""Step functions (the port of ``repro.launch.steps``), eager torch.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``. The reference's step is a pure function that XLA
compiles; here it runs eagerly, takes the gradients with
``torch.autograd.grad`` and updates the parameters and the optimizer state
in place (a second copy of yi-6b's parameters would not fit beside its
gradients and moments), returning the same trees.

On a device mesh the parameters and the optimizer state are ``DTensor``s
(``launch/train.py`` places them by ``parallel/sharding.py``'s rules): the
step places the batch by ``batch_sharding``, runs the loss on DTensors with
the plain tensors it makes (positions, masks, accumulators) taken as
replicated (``implicit_replication``), and places every gradient like its
parameter before the optimizer, which updates the local shards.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import local
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as sh


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _mesh_of(leaf):
    from torch.distributed.tensor import DTensor

    return leaf.device_mesh if isinstance(leaf, DTensor) else None


def make_train_step(
    model: Model,
    opt_cfg: adamw.AdamWConfig,
    *,
    accum_steps: int = 1,
    grad_compression: Optional[str] = None,  # None | "int8"
    schedule: Callable = warmup_cosine,
    grad_shardings=None,
    grad_dtype: Optional[torch.dtype] = None,
    microbatch_loop: Optional[Callable] = None,
) -> Callable:
    """With ``accum_steps > 1`` the batch's leading axis is split into that
    many microbatches, run one after another, their gradients summed in f32
    (or in ``grad_dtype``) and divided by ``accum_steps``, as are the
    metrics. ``grad_compression="int8"`` puts each gradient through the int8
    round trip before the optimizer. The LR schedule is applied to the
    optimizer's step counter. On a mesh, ``grad_shardings`` (a tree of
    placements matching the parameters, ``sharding.params_sharding``)
    places the accumulator, and each microbatch's gradient before it is
    added, as the reference's ``_constrain`` does; without it they are
    placed like the parameters (a DTensor accumulator needs its placements
    up front, where the reference leaves them to propagation).
    ``microbatch_loop`` maps the list of microbatches to the iterable the
    accumulation runs over (default: each in turn); the dry run
    (``launch/dryrun.py``) runs the first alone inside its trace's loop
    count, as a compiled step runs its loop body once per trip."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")

    def value_and_grad(params, leaves, batch):
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    def accumulate(params, leaves, mbs, mesh):
        acc_dt = grad_dtype or torch.float32
        if mesh is None:
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
        else:
            acc_pl = (tree.flatten_up_to(params, grad_shardings) if grad_shardings is not None
                      else [p.placements for p in leaves])
            grads = [sh.placed_zeros(p.shape, acc_dt, pl, mesh, local(p).device)
                     for p, pl in zip(leaves, acc_pl)]
        msum = None
        for mb in (microbatch_loop or iter)(mbs):
            m, g = value_and_grad(params, leaves, mb)
            for acc, gi in zip(grads, g):
                gi = gi.to(grad_dtype) if grad_dtype is not None else gi
                if mesh is None:
                    acc += gi
                else:
                    local(acc).add_(local(sh.placed_as(gi, acc.placements)))
            del g
            msum = m if msum is None else {k: msum[k] + m[k] for k in msum}
        grads = [g / accum_steps for g in grads]
        return {k: v / accum_steps for k, v in msum.items()}, grads

    def train_step(params, opt_state, batch):
        leaves = tree.leaves(params)
        mesh = _mesh_of(leaves[0])
        batch = _to_device(batch, local(leaves[0]).device)
        mbs = [batch] if accum_steps == 1 else [
            {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])[i]
             for k, v in batch.items()} for i in range(accum_steps)]
        replicate = contextlib.nullcontext()
        if mesh is not None:
            from torch.distributed.tensor.experimental import implicit_replication

            # each microbatch's rows over the DP axes
            mbs = [sh.distribute(mb, sh.batch_sharding(mb, mesh), mesh) for mb in mbs]
            replicate = implicit_replication()
        for p in leaves:
            p.requires_grad_(True)
        try:
            with replicate:
                if accum_steps == 1:
                    metrics, grads = value_and_grad(params, leaves, mbs[0])
                else:
                    metrics, grads = accumulate(params, leaves, mbs, mesh)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        if mesh is not None:
            grads = [sh.placed_as(g, p.placements) for g, p in zip(grads, leaves)]
            metrics = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                       for k, v in metrics.items()}
        grads = tree.unflatten_like(params, grads)
        if grad_compression == "int8":
            grads = collectives.int8_compress_decompress(grads)
        lr_scale = schedule(local(opt_state["step"]))
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
