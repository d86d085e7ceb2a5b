"""Gradient compression (the port of ``repro.parallel.collectives``).

``int8_compress_decompress`` block-quantises each gradient to int8 (with f32
block scales) and dequantises it at once: placed between the backward pass
and the optimizer, it gives the numerics a data-parallel reduction of the
int8 payload would have. The explicit quantised all-reduce, ``psum_int8``,
needs a device mesh and waits for the multi-device slice (ROADMAP Queue A 8).
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.optim.adamw import dequantize_i8, quantizable, quantize_i8, row_slices


@torch.no_grad()
def int8_compress_decompress(grads):
    """The int8 round trip of every gradient whose last axis divides by 128
    (the others stay exact), in place, a slice along axis 0 at a time (the
    blocks lie along the last axis, so a slice rounds as the whole leaf).
    Returns ``grads``."""
    for g in tree.leaves(grads):
        if not quantizable(g):  # tiny/misaligned leaves: keep exact
            continue
        for sl in row_slices(g.shape):
            g[sl] = dequantize_i8(quantize_i8(g[sl]), dtype=g.dtype)
    return grads
