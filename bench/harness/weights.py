"""Weights from the seed, on the device, in the type they are served in.

The tree has the port's parameter layout (its leaves' names and shapes,
read on the meta device); the values are the benchmark's: one flat buffer
filled with N(0, 1) by a ``torch.Generator`` on the device in a few large
calls, then each leaf's view scaled and shifted in place by the rule for its
name (``rule``). Norm scales, skip weights and biases are drawn around
their usual values, not left at ones or zeros, so that a program that
ignores one is caught by the comparison. The reference reads the same
tensors.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# one normal_ call fills at most this many elements
CHUNK = 2**30


def _fan_in(shape) -> int:
    return shape[-2] if len(shape) >= 2 else shape[-1]


def rule(name: str, shape) -> Tuple[float, float]:
    """(mean, scale) of the leaf called ``name`` of ``shape``."""
    if name == "tok":
        return 0.0, 0.02
    if name in ("w", "D"):            # norm scales, the SSM skip
        return 1.0, 0.1
    if name in ("b", "conv_b", "bq", "bk", "bv"):
        return 0.0, 0.1
    if name == "dt_bias":             # softplus(-4.6) = 0.01
        return -4.6, 0.5
    if name == "A_log":               # around log(1..N), set in fill()
        return 0.0, 0.1
    return 0.0, _fan_in(shape) ** -0.5


def leaves(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    """(path, leaf) in a fixed order: dict keys sorted, tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree) for x in leaves(t, path + (i,))]
    return [(path, tree)]


def rebuild(tree, values: Dict[tuple, torch.Tensor], path=()):
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], values, path + (k,)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(t, values, path + (i,)) for i, t in enumerate(tree))
    return values[path]


def shapes(model):
    """The port's parameter tree on the meta device (shapes and dtypes)."""
    from repro_torch.launch.specs import abstract_params

    return abstract_params(model)


def make(abstract, seed: int, device) -> Tuple[object, torch.Tensor]:
    """(params, flat): the tree of ``abstract``'s structure whose leaves are
    views of one buffer ``flat``, drawn from ``seed`` on ``device``."""
    items = leaves(abstract)
    dtypes = {t.dtype for _, t in items}
    if len(dtypes) != 1:
        raise ValueError(f"leaves of several dtypes: {dtypes}")
    dtype = dtypes.pop()
    total = sum(t.numel() for _, t in items)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=dtype, device=device)
    for c0 in range(0, total, CHUNK):
        flat[c0:c0 + CHUNK].normal_(generator=gen)
    values, at = {}, 0
    for path, t in items:
        view = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
        mean, scale = rule(path[-1], t.shape)
        view.mul_(scale)
        if path[-1] == "A_log":
            n = t.shape[-1]
            view.add_(torch.log(torch.arange(1, n + 1, device=device, dtype=torch.float32))
                      .to(dtype))
        elif mean:
            view.add_(mean)
        values[path] = view
    return rebuild(abstract, values), flat


def checksum(flat: torch.Tensor, chunk: int = 2**26) -> float:
    """Sum of squares in chunks of f32: the same weights give the same
    number, so the weights after the window must read what they read
    before it."""
    total = 0.0
    for c0 in range(0, flat.numel(), chunk):
        total += float(flat[c0:c0 + chunk].float().square().sum())
    return total
