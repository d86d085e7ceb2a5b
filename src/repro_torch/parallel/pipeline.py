"""GPipe-style pipeline parallelism over one mesh axis (the port of
``repro.parallel.pipeline``, default axis ``pod``).

Each rank along ``axis`` holds one stage's parameters (the leading stage dim
of every leaf sharded over ``axis``: a ``DTensor`` with ``Shard(0)`` there,
or a whole tensor of which the rank takes its own slot), and a loop over
``n_micro + n_stages - 1`` clock ticks runs the GPipe schedule: at tick t,
stage s processes microbatch ``t - s`` (bubble ticks compute and discard);
activations move stage -> stage + 1 at the end of each tick (``Ppermute``,
a ring over ``batch_isend_irecv``). The last stage commits its outputs,
and a masked sum over ``axis`` leaves them on every stage. The ranks of the
other mesh axes run the same pipeline on the same data.

Gradients come from autograd: the tick-end permute's backward sends each
cotangent back along the ring, and the masked sum's backward passes the
(replicated) cotangent of the output through to every stage as it is, so a
loss computed on the output on every rank gives the gradient of that one
loss, as the reference's replicated output does. (The sum's backward is not
``torch.distributed.nn.functional.all_reduce``'s, which would add the
cotangents of the stages and count such a loss once per stage.)

Not ``torch.distributed.pipelining.ScheduleGPipe``: that puts the loss
inside the schedule and leaves the output on the last stage only.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import tree


class Ppermute(torch.autograd.Function):
    """``y`` sent to ``dst`` and a tensor of its shape received from
    ``src`` (global ranks, over ``group``); the backward sends the
    cotangent to ``src`` and receives from ``dst``."""

    @staticmethod
    def forward(ctx, y, group, src: int, dst: int):
        ctx.group, ctx.src, ctx.dst = group, src, dst
        return _exchange(y, group, send_to=dst, recv_from=src)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, send_to=ctx.src, recv_from=ctx.dst), None, None, None


def _exchange(y: torch.Tensor, group, send_to: int, recv_from: int) -> torch.Tensor:
    y = y.contiguous()
    out = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y, send_to, group),
           dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _ReplicatedSum(torch.autograd.Function):
    """The sum over ``group`` of each rank's tensor; the output is the same
    on every rank, and so is its cotangent, which goes back to each rank's
    input as it is."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *, mesh,
                   axis: str = "pod") -> torch.Tensor:
    """Run ``stage_fn(params, h) -> h`` as a pipeline over ``axis`` of
    ``mesh``. ``stage_params`` leaves have a leading stage dim equal to the
    axis size, sharded over it; ``x`` is ``[n_micro, micro_batch, ...]``,
    the same on every rank. Returns the outputs, x's shape, on every rank
    (a plain tensor)."""
    from torch.distributed.tensor import DTensor

    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = mesh.get_local_rank(axis)
    x = x.to_local() if isinstance(x, DTensor) else x
    n_micro = x.shape[0]
    assert n_micro >= 1

    def own(leaf):
        if isinstance(leaf, DTensor):
            local = leaf.to_local()
            assert local.shape[0] == 1, "the stage dim must be sharded over the axis"
            return local[0]
        return leaf[stage]

    params = tree.map(own, stage_params)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    # Every rank builds the same graph (the stage picks its values with
    # ``where``), so the backward runs the permutes in the same order on
    # every rank and each one meets its partner.
    inflight = torch.zeros_like(x[0])
    outputs = [torch.zeros_like(x[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (while there is one); the others take
        # the activation permuted in from the previous stage
        x_in = torch.where(first, x[min(t, n_micro - 1)], inflight)
        y = stage_fn(params, x_in)
        out_idx = t - (n_stages - 1)
        if out_idx >= 0:  # the last stage commits microbatch t - (n_stages - 1)
            outputs[out_idx] = torch.where(last, y, outputs[out_idx])
        # one stage feeds itself from x; the last tick's permute feeds no one
        if n_stages > 1 and t < n_micro + n_stages - 2:
            inflight = Ppermute.apply(y, group, prv, nxt)
    # only the last stage holds real outputs: a masked sum replicates them
    mine = torch.where(last, torch.stack(outputs), 0.0)
    return _ReplicatedSum.apply(mine, group)
