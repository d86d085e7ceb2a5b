"""Gradient compression and the quantised all-reduce (the port of
``repro.parallel.collectives``).

``int8_compress_decompress`` block-quantises each gradient to int8 (with f32
block scales) and dequantises it at once: placed between the backward pass
and the optimizer, it gives the numerics a data-parallel reduction of the
int8 payload would have. ``psum_int8`` is the explicit quantised
all-reduce over a process group.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.optim.adamw import (dequantize_i8, local, quantizable, quantize_i8,
                                     row_slices, splits_rows, whole_rows)


@torch.no_grad()
def _roundtrip(g: torch.Tensor) -> None:
    """The int8 round trip of the tensor ``g``, in place, a slice along
    axis 0 at a time (the blocks lie along the last axis, so a slice rounds
    as the whole leaf)."""
    for sl in row_slices(g.shape):
        g[sl] = dequantize_i8(quantize_i8(g[sl]), dtype=g.dtype)


@torch.no_grad()
def int8_compress_decompress(grads):
    """The int8 round trip of every gradient whose last axis divides by 128
    (the others stay exact), in place. Returns ``grads``.

    A ``DTensor`` gradient is quantisable by its global shape, as in the
    reference. Its local shard rounds in place where its last axis is whole
    on every rank; where that axis is sharded the rows are gathered first
    (a shard's width need not divide by 128, and a block must not straddle
    two ranks), rounded, and each rank's shard written back."""
    for g in tree.leaves(grads):
        if not quantizable(g):  # tiny/misaligned leaves: keep exact
            continue
        if not splits_rows(g):
            _roundtrip(local(g))
            continue
        rows = whole_rows(g)
        _roundtrip(rows.to_local())
        g.to_local().copy_(rows.redistribute(g.device_mesh, g.placements).to_local())
    return grads


def psum_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """Explicit quantised all-reduce over ``group`` (default: the world):
    quantise, all-reduce the dequantised (block-scaled) f32 payload, cast
    back to the input dtype. A leaf that is not quantisable takes a plain
    all-reduce. Returns a new tensor; ``x`` is left as it was."""
    import torch.distributed as dist

    if not quantizable(x):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out
    deq = dequantize_i8(quantize_i8(x))
    dist.all_reduce(deq, group=group)
    return deq.to(x.dtype)
