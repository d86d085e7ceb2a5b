"""Activation-sharding context (the port of ``repro.parallel.context``).

Model code is mesh-agnostic; the launcher installs the data-parallel axes
(and the mesh) here, and layers call ``constrain_tokens`` /
``constrain_dims`` at block boundaries. A constraint redistributes a
``DTensor`` to the guarded placements; on a plain tensor, or with no context
installed (unit tests, single-device runs), it is a no-op, as in the
reference.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

_DP_AXES: Optional[Tuple[str, ...]] = None
_TP_AXIS: Optional[str] = None
_TP_SIZE: int = 1
_SP_SEQ: bool = False  # sequence-parallel activations between blocks
_MESH = None  # the DeviceMesh of the local_map code paths
_MOE_PIN = False  # pin the MoE dispatch's shardings


def install(dp_axes: Tuple[str, ...], tp_axis: str = "model",
            tp_size: int = 1, sp_seq: bool = False, mesh=None,
            moe_pin: bool = False) -> None:
    global _DP_AXES, _TP_AXIS, _TP_SIZE, _SP_SEQ, _MESH, _MOE_PIN
    _DP_AXES, _TP_AXIS, _TP_SIZE, _SP_SEQ, _MESH, _MOE_PIN = (
        tuple(dp_axes), tp_axis, tp_size, sp_seq, mesh, moe_pin
    )


def clear() -> None:
    global _DP_AXES, _TP_AXIS, _TP_SIZE, _SP_SEQ, _MESH, _MOE_PIN
    _DP_AXES, _TP_AXIS, _TP_SIZE, _SP_SEQ, _MESH, _MOE_PIN = (
        None, None, 1, False, None, False
    )


def moe_pin() -> bool:
    return _MOE_PIN


def mesh():
    return _MESH


def dp_axes():
    return _DP_AXES


@contextlib.contextmanager
def activation_sharding(dp_axes: Tuple[str, ...], tp_axis: str = "model",
                        tp_size: int = 1, sp_seq: bool = False):
    prev = (_DP_AXES, _TP_AXIS, _TP_SIZE, _SP_SEQ)
    install(dp_axes, tp_axis, tp_size, sp_seq, mesh=_MESH, moe_pin=_MOE_PIN)
    try:
        yield
    finally:
        if prev[0] is not None:
            install(*prev, mesh=_MESH, moe_pin=_MOE_PIN)
        else:
            clear()


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _constrain(x, spec: Tuple):
    """Redistribute the DTensor ``x`` to the placements of ``spec`` on its
    own mesh (a no-op when it has them already)."""
    from repro_torch.parallel.sharding import placements

    target = placements(spec, x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def constrain_dims(x: torch.Tensor, dims: Tuple) -> torch.Tensor:
    """Generic constraint: ``dims`` entries are 'dp', 'tp', or None per
    leading axis (trailing axes unconstrained, i.e. replicated). The 'tp'
    entries are divisibility-guarded; a no-op without an installed context
    or on a plain tensor."""
    if _DP_AXES is None or not _is_dtensor(x):
        return x
    spec = []
    for i, d in enumerate(dims[: x.ndim]):
        if d == "dp":
            spec.append(_DP_AXES)
        elif d == "tp":
            spec.append(_TP_AXIS if x.shape[i] % max(1, _TP_SIZE) == 0 else None)
        else:
            spec.append(None)
    spec += [None] * (x.ndim - len(spec))
    return _constrain(x, tuple(spec))


def constrain_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, S, D] (or [B, S]) activations: batch over DP; with SP enabled the
    seq dim additionally shards over TP."""
    if _DP_AXES is None or not _is_dtensor(x):
        return x
    if x.ndim == 3:
        seq_ax = (
            _TP_AXIS if (_SP_SEQ and x.shape[1] % max(1, _TP_SIZE) == 0
                         and x.shape[1] >= _TP_SIZE) else None
        )
        spec = (_DP_AXES, seq_ax, None)
    elif x.ndim == 2:
        spec = (_DP_AXES, None)
    else:
        return x
    return _constrain(x, spec)


def batch_only(x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` with its leading dim over its mesh's DP axes and
    every other dim whole, whether or not a context is installed (the
    regions whose ops have no DTensor strategy for a sharded feature dim);
    a plain tensor as it is."""
    if not _is_dtensor(x):
        return x
    from repro_torch.launch.mesh import dp_axes as mesh_dp_axes

    return _constrain(x, (mesh_dp_axes(x.device_mesh),) + (None,) * (x.ndim - 1))


def map_rows(fn, args, rows, n_out: int = 1):
    """``fn(*args)`` on each rank's batch rows (``local_map`` over the DP
    axes) where an argument is a ``DTensor``; a plain call where none is.

    ``rows[i]`` says whether ``args[i]`` is batched on its dim 0: it then
    goes in with that dim over the DP axes and every other dim whole;
    otherwise (a weight, a table) it goes in whole on every rank and its
    gradient is summed over the DP axes. Arguments that are not DTensors
    go in as they are. Every output is batched on its dim 0. This is the
    port's ``shard_map`` over the DP axes: the regions whose ops have no
    DTensor sharding strategy (the MoE's gathers, the recurrent mixers'
    scans), listed in ``PERF.md`` section 3."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.mesh import axis_names, dp_axes as mesh_dp_axes

    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    mesh = first.device_mesh
    dp = mesh_dp_axes(mesh)
    names = axis_names(mesh)
    batched = [Shard(0) if a in dp else Replicate() for a in names]
    whole = [Replicate()] * len(names)
    summed = [Partial() if a in dp else Replicate() for a in names]
    ins, in_pl, grad_pl = [], [], []
    for a, r in zip(args, rows):
        if not isinstance(a, DTensor):
            ins.append(a)
            in_pl.append(None)
            grad_pl.append(None)
            continue
        pl = batched if r else whole
        if list(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        ins.append(a)
        in_pl.append(pl)
        grad_pl.append(pl if r else summed)
    out_pl = batched if n_out == 1 else tuple([batched] * n_out)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh)(*ins)
