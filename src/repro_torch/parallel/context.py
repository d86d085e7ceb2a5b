"""Activation-sharding context (the port of ``repro.parallel.context``).

Model code is mesh-agnostic; the launcher installs the data-parallel axes
(and the mesh) here, and layers call ``constrain_tokens`` /
``constrain_dims`` at block boundaries. A constraint redistributes a
``DTensor`` to the guarded placements; on a plain tensor, or with no context
installed (unit tests, single-device runs), it is a no-op, as in the
reference.

Inside a block, each part's products run in one explicit region
(``region``, over ``local_map``), whose collectives its placements state
in both directions, in the layout ``pick_layout`` picks from shapes;
``map_rows`` runs the regions that have no DTensor strategy on each
rank's batch rows. On plain tensors both are plain calls.
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


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def tp_size(mesh) -> int:
    """The ranks of ``mesh``'s ``model`` axis (1 where it has none)."""
    from repro_torch.launch.mesh import shape_of

    return shape_of(mesh).get("model", 1)


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
    if _DP_AXES is None or not is_dtensor(x):
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
    if _DP_AXES is None or not is_dtensor(x):
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


def whole_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, S, D] activations with the sequence dim whole: a DTensor whose
    dim 1 is sharded (the sequence-parallel activations between blocks,
    ``constrain_tokens`` with ``sp_seq``) is gathered over those mesh dims,
    as sequence parallelism gathers a block's normed input before its
    mixer's and MLP's products (``transformer.apply_block``). Left to
    DTensor, a product flattens [B, S, D] into [B * S, D] with S sharded,
    which torch 2.11 refuses and torch 2.13 plans as strided shards, at
    length on a mesh of three dims. A plain tensor, or one whose sequence
    is whole, is returned as it is."""
    if not is_dtensor(x) or x.ndim != 3 or not any(p.is_shard(1) for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_shard(1) else p for p in x.placements])


def residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y``, a block's output ``y`` first placed like the residual
    stream ``x`` where both are DTensors: a differentiable redistribution,
    so the backward hands ``y``'s producer its gradient in ``y``'s own
    placements (with sequence-parallel ``x``, the reduce-scatter onto the
    sequence shards in the forward and its all-gather in the backward).
    Left to the add, the gradient would reach the product that made ``y``
    sharded over the sequence, which its backward cannot flatten on
    torch 2.11."""
    if is_dtensor(x) and is_dtensor(y) and tuple(x.placements) != tuple(y.placements):
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def batch_only(x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` with its leading dim over its mesh's DP axes and
    every other dim whole, whether or not a context is installed (the
    regions whose ops have no DTensor strategy for a sharded feature dim);
    a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from repro_torch.launch.mesh import dp_axes as mesh_dp_axes

    return _constrain(x, (mesh_dp_axes(x.device_mesh),) + (None,) * (x.ndim - 1))


def whole(w: torch.Tensor) -> torch.Tensor:
    """A DTensor ``w`` whole on every rank (replicated over every mesh
    dim), a plain tensor as it is: a weight gathered once before a loop
    whose steps each take it whole."""
    return _constrain(w, (None,) * w.ndim) if is_dtensor(w) else w


class _SumEachUse(torch.autograd.Function):
    """The identity in the forward. In the backward the gradients, each a
    partial sum over the DP axes (a weight taken whole by a region whose
    rows are the local batch), are summed over them at once: the local
    gradients flattened together, one all-reduce per DP axis."""

    @staticmethod
    def forward(ctx, *ws):
        return tuple(w.view_as(w) for w in ws)

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed._functional_collectives import all_reduce, wait_tensor
        from torch.distributed.tensor import DTensor, Replicate

        from repro_torch.launch.mesh import axis_names, dp_axes as mesh_dp_axes

        mesh = grads[0].device_mesh
        names = axis_names(mesh)
        dims = [names.index(a) for a in mesh_dp_axes(mesh)]
        for g in grads:
            if not all(g.placements[i].is_partial() for i in dims):
                raise ValueError(f"a gradient placed {g.placements} is not a partial "
                                 f"sum over the DP axes {mesh_dp_axes(mesh)}")
        local = [g.to_local() for g in grads]
        flat = torch.cat([t.reshape(-1) for t in local])
        for i in dims:
            flat = wait_tensor(all_reduce(flat, "sum", (mesh, i)))
        out, at = [], 0
        for g, t in zip(grads, local):
            pl = [Replicate() if i in dims else p for i, p in enumerate(g.placements)]
            out.append(DTensor.from_local(flat[at:at + t.numel()].view(t.shape), mesh, pl,
                                          run_check=False, shape=g.shape, stride=g.stride()))
            at += t.numel()
        return tuple(out)


def sum_each_use(*ws):
    """``ws`` as they are, their gradients summed over the DP axes where
    this use of them ends in the backward, all of them in one all-reduce
    per DP axis, and not once after the last use: the reference's scans
    psum a replicated weight's cotangent in their body, at every step. A
    plain call on plain tensors."""
    if not ws or not is_dtensor(ws[0]):
        return ws
    return _SumEachUse.apply(*ws)


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


# --------------------------------------------------------------------------
# explicit layout regions for a block's products
# --------------------------------------------------------------------------

# the two layouts of a block part's products on a mesh
TOKEN_GATHERED = "token_gathered"  # Megatron sequence parallelism
WEIGHT_GATHERED = "weight_gathered"  # FSDP-style: tokens stay, weights move
ROW_SUM = "row_sum"  # a region output that is the row product's [B, S, D]


def pick_layout(weight_shapes, d_model: int, tokens: int, mesh, sp_seq: bool,
                dtype: torch.dtype) -> str:
    """The layout of a block part whose products take the weights of
    ``weight_shapes`` (each ``(rows, cols)``) over ``tokens`` activations of
    width ``d_model`` per rank (as they sit between blocks, a sequence
    shard where ``sp_seq``), on ``mesh`` (a ``DeviceMesh`` or a stand-in):
    the one whose forward and backward move fewer ring link bytes over
    ``model`` (``hlo_features.ring_bytes``, the port's one ring model). Both
    layouts gather the weights' FSDP shards over ``data`` alike, so only
    the ``model`` traffic is compared: the token-gathered layout moves the
    activations (an all-gather of the tokens and a reduce-scatter of the
    row product's sum, and the mirror image in the backward), the
    weight-gathered layout the weights (an all-gather over ``model``, and a
    reduce-scatter of their gradients). Without ``sp_seq`` the tokens are
    whole on every ``model`` rank, so the weight-gathered layout would run
    the whole part on each, tp times the token-gathered layout's products:
    the tokens stay gathered. A pure function of shapes, the same on every
    rank; a tie keeps the tokens gathered."""
    from repro_torch.core.hlo_features import ring_bytes

    tp = tp_size(mesh)
    if tp == 1 or not sp_seq:
        return TOKEN_GATHERED
    item = torch.empty((), dtype=dtype).element_size()
    act = tokens * d_model * item
    moved = (ring_bytes("all-gather", act * tp, tp)[1]
             + ring_bytes("reduce-scatter", act, tp)[1])
    weights = sum(r * c for r, c in weight_shapes) * item
    gathered = (ring_bytes("all-gather", weights, tp)[1]
                + ring_bytes("reduce-scatter", weights / tp, tp)[1])
    return WEIGHT_GATHERED if gathered < 2 * moved else TOKEN_GATHERED


def layout_of(weight_shapes, x: torch.Tensor) -> str:
    """``pick_layout`` for the products of ``weight_shapes`` over the
    [B, S, D] DTensor ``x``, from its global shape and placements (so the
    same on every rank)."""
    from repro_torch.launch.mesh import axis_names

    mesh = x.device_mesh
    names = axis_names(mesh)
    tokens = x.shape[0] * x.shape[1]
    sp = False
    for i, p in enumerate(x.placements):
        if p.is_shard(0) or p.is_shard(1):
            tokens //= mesh.size(i)
        sp = sp or (p.is_shard(1) and names[i] == "model")
    return pick_layout(weight_shapes, x.shape[-1], tokens, mesh, sp, x.dtype)


def region(fn, tokens, weights, layout: str = TOKEN_GATHERED, split: bool = True,
           outs=(ROW_SUM,)):
    """``fn(*tokens, *weights)`` on each rank's local tensors (``local_map``),
    every collective of the region stated in both directions by its in,
    out and gradient placements; a plain call where ``tokens[0]`` is not a
    ``DTensor``.

    ``tokens`` are [B, S, D] activations; ``weights`` are ``(tensor, dim)``
    pairs, ``dim`` the weight's dim that ``model`` shards where the region
    is split (a column product's last, a row product's first), ``None``
    for a weight each rank holds whole. The batch rows stay on their DP
    shards. With ``layout`` ``TOKEN_GATHERED`` the tokens' other dims are
    gathered (the sequence, once per block part) and, with ``split``, the
    products run on each rank's ``model`` shard of the weights, so a row
    product leaves a partial sum over ``model``, and the tokens' gradient is
    a partial sum that the backward reduce-scatters (or all-reduces) onto
    their shards. With ``WEIGHT_GATHERED`` the tokens stay on their shards
    and every weight goes in whole: its gradient is summed over the mesh
    dims whose ranks hold other tokens. Either way a weight's FSDP shards
    are gathered and its gradient reduce-scattered back onto them.

    ``outs`` names each output of ``fn``: ``ROW_SUM`` for a row product's
    [B, S, D], returned placed like ``tokens[0]`` (with sequence-parallel
    tokens the reduce-scatter onto the sequence shards, else the
    all-reduce, and in the backward the all-gather of its gradient), or the
    output's dim that ``model`` shards where the region is split (``None``:
    whole), its dim 0 over the tokens' batch shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.mesh import axis_names
    from repro_torch.parallel.sharding import placed_as

    x = tokens[0]
    if not isinstance(x, DTensor):
        return fn(*tokens, *(w for w, _ in weights))
    mesh = x.device_mesh
    names = axis_names(mesh)
    n = len(names)
    tp = names.index("model") if tp_size(mesh) > 1 else None
    gathered = layout == TOKEN_GATHERED
    split = split and gathered and tp is not None
    rep = Replicate()

    def tokens_in(t):
        return [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(1) and not gathered
                else rep for p in t.placements]

    tok_pl = [tokens_in(t) for t in tokens]
    varies = [any(pl[i] != rep for pl in tok_pl) or (split and i == tp) for i in range(n)]
    w_pl = [[Shard(d) if split and i == tp and d is not None else rep for i in range(n)]
            for _, d in weights]
    in_pl = tok_pl + w_pl
    grad_pl = [tuple(p if p != rep else Partial() if varies[i] else rep
                     for i, p in enumerate(pl)) for pl in in_pl]
    row = tok_pl[0]
    out_pl = []
    for o in outs:
        if o == ROW_SUM:
            out_pl.append([Partial() if split and i == tp else p for i, p in enumerate(row)])
        else:
            out_pl.append([Shard(o) if split and i == tp and o is not None
                           else Shard(0) if row[i].is_shard(0) else rep for i in range(n)])
    ins = [placed_as(t, pl) for t, pl in zip(list(tokens) + [w for w, _ in weights], in_pl)]
    res = local_map(fn, out_placements=out_pl[0] if len(outs) == 1 else tuple(out_pl),
                    in_placements=tuple(tuple(pl) for pl in in_pl),
                    in_grad_placements=tuple(grad_pl), device_mesh=mesh)(*ins)
    res = [res] if len(outs) == 1 else list(res)
    res = [placed_as(r, x.placements) if o == ROW_SUM else r for r, o in zip(res, outs)]
    return res[0] if len(outs) == 1 else tuple(res)
