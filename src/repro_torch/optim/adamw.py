"""AdamW with dtype-configurable or int8-block-quantised moments (the port
of ``repro.optim.adamw``).

The state dtype is ``"float32"``, ``"bfloat16"`` or ``"int8"``: block-wise
quantised, with one f32 scale per 128-wide block along the last axis, for
leaves of at least 65536 elements whose last axis divides by 128; bf16 for
the others.

The reference decodes each whole leaf to f32 and builds the new moments and
parameters from f32 temporaries, about five of them per leaf: at yi-6b's
stacked MLP leaves ([32, 4096, 11008]) each is 5.4 GiB. The port walks a
leaf along axis 0 in slices of at most ``SLICE_ELEMS`` elements (one layer
group at a time for those leaves), so its transient stays bounded, and
updates the parameters and the moments in place. The int8 blocks lie along
the last axis, so a slice quantises exactly as the whole leaf does: the
numbers are the reference's, up to the order in which the global norm sums
its squares.

On a device mesh the leaves are ``DTensor``s placed by the sharding rules
(gradients placed like their parameters). The update is elementwise, so it
runs on each rank's local shards in place; ``global_norm`` adds each
shard's squares, each scaled by one over the number of ranks that hold the
same shard, and all-reduces the total over the mesh once. An int8 leaf
whose last (blocked) axis is sharded is updated with whole rows: its
parameter, gradient and moments are gathered along that axis, updated as on
one device and scattered back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List

import torch

from repro_torch import tree
from repro_torch.spans import span

_BLOCK = 128
# a leaf is updated in slices along axis 0 of at most this many elements
# (a 256 MiB f32 temporary each)
SLICE_ELEMS = 2**26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # float32 | bfloat16 | int8


# ---------------------------------------------------------------------------
# int8 block quantisation (shape-preserving: q keeps the tensor's shape, the
# f32 scales get a trailing block dim)
# ---------------------------------------------------------------------------


def quantizable(x: torch.Tensor) -> bool:
    return x.ndim >= 1 and x.shape[-1] % _BLOCK == 0


def quantize_i8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    if not quantizable(x):
        raise ValueError(f"the last axis of {tuple(x.shape)} is not a multiple of {_BLOCK}")
    blocks = x.float().reshape(*x.shape[:-1], -1, _BLOCK)
    scale = blocks.abs().amax(-1) / 127.0  # [..., L/128]
    q = torch.round(blocks / scale[..., None].clamp_min(1e-12)).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale}


def dequantize_i8(st: Dict[str, torch.Tensor],
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    q = st["q"]
    blocks = q.float().reshape(*q.shape[:-1], -1, _BLOCK)
    return (blocks * st["scale"][..., None]).reshape(q.shape).to(dtype)


# ---------------------------------------------------------------------------
# state handling
# ---------------------------------------------------------------------------


def _int8_leaf(x: torch.Tensor, dtype: str) -> bool:
    """Whether the int8 state quantises this leaf's moments (the
    reference's ``_encode_moment`` rule); its other leaves keep bf16."""
    return dtype == "int8" and quantizable(x) and x.numel() >= 65536


def _decode_moment(st) -> torch.Tensor:
    if isinstance(st, dict):
        return dequantize_i8(st)
    return st.float()


def _store_moment(st, x: torch.Tensor) -> None:
    """Write the f32 moment ``x`` into ``st`` in place, in the form ``st``
    has: quantised for an int8 leaf, cast for the others."""
    if isinstance(st, dict):
        for k, val in quantize_i8(x).items():
            st[k].copy_(val)
    else:
        st.copy_(x)


def init_state(cfg: AdamWConfig, params) -> Dict[str, Any]:
    """``{step: int32 0, m, v}``, the moments zero in the state dtype (int8
    leaves as ``{q, scale}``), on the parameters' devices."""

    def zero_like(p):
        if _int8_leaf(p, cfg.state_dtype):
            return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    "scale": torch.zeros(p.shape[:-1] + (p.shape[-1] // _BLOCK,),
                                         device=p.device)}
        dt = torch.bfloat16 if cfg.state_dtype == "int8" else getattr(torch, cfg.state_dtype)
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = local(tree.leaves(params)[0]).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree.map(zero_like, params), "v": tree.map(zero_like, params)}


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def local(t):
    """A DTensor's local shard (a view of its storage); a tensor as it is."""
    return t.to_local() if isinstance(t, _dtensor()) else t


def row_slices(shape) -> Iterator[slice]:
    """Slices along axis 0 of at most ``SLICE_ELEMS`` elements (at least one
    row); one slice for a leaf of fewer than two axes."""
    if len(shape) < 2:
        yield slice(None)
        return
    row = max(1, int(torch.Size(shape[1:]).numel()))
    step = max(1, SLICE_ELEMS // row)
    for r0 in range(0, shape[0], step):
        yield slice(r0, r0 + step)


def _part(st, sl):
    """A slice along axis 0 of a moment (both halves of an int8 one)."""
    if isinstance(st, dict):
        return {k: v[sl] for k, v in st.items()}
    return st[sl]


def _copies(t) -> int:
    """How many ranks of its mesh hold each shard of the DTensor ``t``."""
    from torch.distributed.tensor import Replicate

    n = 1
    for size, pl in zip(t.device_mesh.shape, t.placements):
        if isinstance(pl, Replicate):
            n *= size
        elif not pl.is_shard():
            raise ValueError(f"a leaf placed {tuple(t.placements)}: place gradients "
                             "like their parameters before the update")
    return n


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient in f32, slice by slice
    (on a mesh: over the local shards, then all-reduced)."""
    DTensor = _dtensor()
    total = torch.zeros((), device=local(grads[0]).device)
    mesh = None
    for g in grads:
        n = 1
        if isinstance(g, DTensor):
            mesh, n = g.device_mesh, _copies(g)
            g = g.to_local()
        for sl in row_slices(g.shape):
            sq = g[sl].float().square().sum()
            total = total + (sq if n == 1 else sq / n)
    if mesh is not None:
        from torch.distributed.tensor import Partial

        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim).full_tensor()
    return total.sqrt()


def apply_updates(cfg: AdamWConfig, params, grads, state: Dict[str, Any],
                  lr_scale=1.0):
    """Global-norm clip + AdamW, in place: the parameters and the moments
    are written slice by slice. Returns (params, state, {"grad_norm": the
    norm before clipping})."""
    with torch.no_grad(), span("optimizer"):
        return _apply_updates(cfg, params, grads, state, lr_scale)


def _update_leaf(cfg, p, g, m_st, v_st, clip, bc1, bc2, lr) -> None:
    """AdamW on one leaf's tensors (local), in place, slice by slice."""
    for sl in row_slices(p.shape):
        ps, ms, vs = p[sl], _part(m_st, sl), _part(v_st, sl)
        gs = g[sl].float() * clip
        m = _decode_moment(ms)
        v = _decode_moment(vs)
        m = cfg.b1 * m + (1 - cfg.b1) * gs
        v = cfg.b2 * v + (1 - cfg.b2) * gs * gs
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        update = update + cfg.weight_decay * ps.float()
        ps.copy_((ps.float() - lr * update).to(p.dtype))
        _store_moment(ms, m)
        _store_moment(vs, v)


def _row_placements(t) -> list:
    """The DTensor ``t``'s placements with its last axis whole (every other
    placement kept)."""
    from torch.distributed.tensor import Replicate

    last = t.ndim - 1
    return [Replicate() if p.is_shard() and p.dim in (last, -1) else p
            for p in t.placements]


def splits_rows(t) -> bool:
    """Whether ``t`` is a DTensor whose last axis is sharded, so that an
    int8 block along it may straddle two ranks."""
    return isinstance(t, _dtensor()) and _row_placements(t) != list(t.placements)


def whole_rows(t):
    """The DTensor ``t`` with its last axis gathered where it is sharded:
    int8 blocks along that axis then lie whole on each rank. ``t`` itself
    where they do."""
    return t.redistribute(t.device_mesh, _row_placements(t)) if splits_rows(t) else t


def _update_sharded_blocks(cfg, p, g, m_st, v_st, *scalars) -> None:
    """The update of an int8 leaf whose last axis is sharded: on whole rows,
    then each rank's shard written back."""
    trees = [p, g, m_st, v_st]
    whole = [{k: whole_rows(v) for k, v in t.items()} if isinstance(t, dict)
             else whole_rows(t) for t in trees]
    _update_leaf(cfg, *[{k: local(v) for k, v in t.items()} if isinstance(t, dict)
                        else local(t) for t in whole], *scalars)
    for t, w in ((p, whole[0]), (m_st, whole[2]), (v_st, whole[3])):
        for dst, src in ([(t[k], w[k]) for k in t] if isinstance(t, dict) else [(t, w)]):
            if src is not dst:
                dst.to_local().copy_(src.redistribute(dst.device_mesh,
                                                      dst.placements).to_local())


def _apply_updates(cfg, params, grads, state, lr_scale):
    flat_p = tree.leaves(params)
    flat_g = tree.flatten_up_to(params, grads)
    flat_m = tree.flatten_up_to(params, state["m"])
    flat_v = tree.flatten_up_to(params, state["v"])
    gnorm = global_norm(flat_g)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step_st = state["step"]
    step = local(step_st) + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale
    DTensor = _dtensor()

    for p, g, m_st, v_st in zip(flat_p, flat_g, flat_m, flat_v):
        if isinstance(m_st, dict) and splits_rows(p):
            _update_sharded_blocks(cfg, p, g, m_st, v_st, clip, bc1, bc2, lr)
            continue
        if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
            raise ValueError(f"a gradient placed {tuple(g.placements)}, its parameter "
                             f"{tuple(p.placements)}")
        moments = [{k: local(x) for k, x in st.items()} if isinstance(st, dict) else local(st)
                   for st in (m_st, v_st)]
        _update_leaf(cfg, local(p), local(g), *moments, clip, bc1, bc2, lr)
    if isinstance(step_st, DTensor):
        step = DTensor.from_local(step, step_st.device_mesh, step_st.placements)
    state["step"] = step
    return params, state, {"grad_norm": gnorm}
