"""Conversion of reference parameters into the port's.

The port keeps the reference's parameter tree one-to-one: the same nested
dict keys, the layer stack as a tuple with one dict per pattern position,
and every stacked leaf ``[G, ...]`` in the same axis order. So conversion is
a leaf-by-leaf copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.hw import resolve_device


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: go through float32
        return torch.tensor(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.tensor(a).to(device)  # a copy: the source may be read-only


def from_jax(params_np, device="cuda"):
    """The reference parameter tree, as nested dicts and tuples of numpy
    arrays (e.g. ``jax.tree.map(np.asarray, params)``), as torch tensors on
    ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        return _leaf(node, dev)

    return conv(params_np)
