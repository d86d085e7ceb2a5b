"""Divisibility-aware sharding rules: DP / FSDP / TP / EP / SP (the port of
``repro.parallel.sharding``, an own copy of its rules).

  * batch dims           -> DP over ('pod', 'data')
  * TP feature dims      -> 'model' (attention heads / d_ff / vocab / d_inner)
  * FSDP storage dim     -> 'data'
  * MoE expert dim       -> 'model' (EP)
  * KV-cache             -> heads over 'model' when divisible, else the
                            sequence dim over 'model' (flash-decode SP)

A spec is the reference's ``PartitionSpec`` as a plain tuple: per tensor dim
an axis name, a tuple of axis names or ``None`` (``P`` normalises as jax
does: a one-name tuple becomes the name, an empty one ``None``). Every rule
is guarded: a dim is sharded only if its size divides the product of its
mesh axes. ``param_spec`` and ``cache_spec`` return specs; the ``*_sharding``
functions return, per leaf, the ``DTensor`` placements of ``placements``:
for each mesh dim ``Shard(d)`` of the tensor dim ``d`` that names it, else
``Replicate()``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.launch.mesh import axis_names, dp_axes, shape_of

FSDP = "data"
TP = "model"


def P(*entries) -> Tuple:
    """A spec, normalised as ``jax.sharding.PartitionSpec`` normalises."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


# trailing-dim specs by leaf name (left-padded with None to the leaf's ndim)
_PARAM_RULES: Dict[str, Tuple] = {
    # embedding / head
    "tok": (TP, FSDP),
    "head": (FSDP, TP),
    "enc_pos": (None, FSDP),
    "vis_proj": (FSDP, TP),
    # attention
    "wq": (FSDP, TP),
    "wk": (FSDP, TP),
    "wv": (FSDP, TP),
    "wo": (TP, FSDP),
    "bq": (TP,),
    "bk": (TP,),
    "bv": (TP,),
    # dense mlp (trailing 2 dims); the MoE's rank-4 leaves take _MOE_3D
    "w1": (FSDP, TP),
    "w3": (FSDP, TP),
    "w2": (TP, FSDP),
    "router": (FSDP, None),
    # mamba
    "in_proj": (FSDP, TP),
    "out_proj": (TP, FSDP),
    "conv_w": (None, TP),
    "conv_b": (TP,),
    "w_bc": (TP, None),
    "w_dt": (TP, None),
    "dt_proj": (None, TP),
    "dt_bias": (TP,),
    "A_log": (TP, None),
    "D": (TP,),
    # mlstm / slstm
    "w_i": (FSDP, TP),
    "w_f": (FSDP, TP),
    "f_bias": (TP,),
    "w_o": (FSDP, TP),
    "scale": (TP,),
    "w_in": (FSDP, TP),
    "r": (None, None, TP),
    "b": (TP,),  # slstm bias; a norm's 'b' is caught by its parent first
}

_MOE_3D = {"w1": (TP, FSDP, None), "w3": (TP, FSDP, None), "w2": (TP, None, FSDP)}

_NORM_PARENTS = ("norm1", "norm2", "norm_x", "norm_f", "enc_norm_f", "norm")


def _path_names(path) -> Tuple[str, ...]:
    """A leaf's path (``tree.key_paths``) as the reference names it: dict
    keys as strings, sequence indices as ``[i]``."""
    return tuple(f"[{k}]" if isinstance(k, int) else str(k) for k in path)


def _guard(spec: Tuple, shape: Tuple[int, ...], mesh) -> Tuple:
    """Left-pad to ndim and drop axes that don't divide the dim."""
    spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
    spec = spec[-len(shape):] if shape else ()
    names, sizes = axis_names(mesh), shape_of(mesh)
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        size = 1
        for a in axes:
            if a not in names:
                size = 0
                break
            size *= sizes[a]
        out.append(ax if size and dim % size == 0 else None)
    return P(*out)


def head_aware_overrides(cfg, mesh) -> Dict[str, Tuple]:
    """Config-aware rule overrides (Megatron-style), as the reference's:

      * kv_heads % tp != 0  -> replicate the K/V projections;
      * heads % tp != 0     -> replicate Q/O too;
      * mLSTM/sLSTM with heads % tp != 0 -> replicate the mixers' feature
        dims.
    """
    tp = shape_of(mesh).get(TP, 1)
    ov: Dict[str, Tuple] = {}
    if cfg is None or tp == 1:
        return ov
    if cfg.n_kv_heads % tp != 0:
        ov.update({"wk": (FSDP, None), "wv": (FSDP, None),
                   "bk": (None,), "bv": (None,)})
    if cfg.n_heads % tp != 0:
        ov.update({"wq": (FSDP, None), "bq": (None,), "wo": (None, FSDP)})
        if cfg.default_mixer in ("mlstm",) or cfg.slstm_every:
            ov.update({
                "w_i": (FSDP, None), "w_f": (FSDP, None), "f_bias": (None,),
                "w_o": (FSDP, None), "scale": (None,),
                "out_proj": (None, FSDP),
                "w_in": (FSDP, None), "r": (None, None, None), "b": (None,),
            })
    return ov


def param_spec(path, leaf, mesh, overrides: Optional[Dict[str, Tuple]] = None) -> Tuple:
    names = _path_names(path)
    name = names[-1]
    parents = names[:-1]
    if any(p in _NORM_PARENTS for p in parents[-2:]):
        return P()
    rule: Optional[Tuple] = None
    # MoE expert weights are the only rank-4 w1/w2/w3 leaves ([G, E, D, F]);
    # dense (incl. shared-expert) stacks are rank 3 ([G, D, F]).
    if name in _MOE_3D and len(leaf.shape) == 4 and "shared" not in parents:
        rule = _MOE_3D[name]
    if rule is None and overrides:
        rule = overrides.get(name)
    if rule is None:
        rule = _PARAM_RULES.get(name)
    if rule is None:
        return P()
    return _guard(rule, tuple(leaf.shape), mesh)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: Tuple, mesh) -> Tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names it (alone or in a tuple of
    axes, which then shards ``d`` over those mesh dims in order), else
    ``Replicate()``. A mesh dim of one rank holds every dim whole either
    way and takes ``Replicate()``: DTensor refuses to reshape a dim sharded
    there when its size is 1 (a microbatch of one row)."""
    from torch.distributed.tensor import Replicate, Shard

    owner: Dict[str, int] = {}
    for d, ax in enumerate(spec):
        for a in ((ax,) if isinstance(ax, str) else tuple(ax or ())):
            owner[a] = d
    sizes = shape_of(mesh)
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1 else Replicate()
                 for a in axis_names(mesh))


def replicated(mesh) -> Tuple:
    return placements(P(), mesh)


def params_sharding(params_shape, mesh, cfg=None):
    """A tree of placements matching an (abstract) parameter tree."""
    ov = head_aware_overrides(cfg, mesh)
    return tree_mod.map_with_path(
        lambda path, leaf: placements(param_spec(path, leaf, mesh, overrides=ov), mesh),
        params_shape)


def _moment_specs(ps: Tuple, moment, mesh):
    """A moment's spec(s) from its parameter's: int8 ``{q, scale}`` keep the
    shape, so ``q`` takes the parameter's spec and the scale drops the last
    (blocked) dim's axis."""
    if isinstance(moment, dict):
        sc = P(*(ps[:-1] + (None,))) if len(ps) else P()
        return {"q": _guard(ps, tuple(moment["q"].shape), mesh),
                "scale": _guard(sc, tuple(moment["scale"].shape), mesh)}
    return ps


def opt_state_specs(opt_shape, params_shape, mesh, cfg=None):
    """Specs of the optimizer state: the moments mirror the parameters,
    ``step`` is replicated."""
    ov = head_aware_overrides(cfg, mesh)
    pspecs = [param_spec(path, leaf, mesh, overrides=ov) for path, leaf
              in zip(tree_mod.key_paths(params_shape), tree_mod.leaves(params_shape))]
    out = {"step": P()}
    for key in ("m", "v"):
        moments = tree_mod.flatten_up_to(params_shape, opt_shape[key])
        out[key] = tree_mod.unflatten_like(
            params_shape, [_moment_specs(ps, m, mesh) for ps, m in zip(pspecs, moments)])
    return out


def opt_state_sharding(opt_shape, params_shape, mesh, cfg=None):
    specs = opt_state_specs(opt_shape, params_shape, mesh, cfg)

    def one(s):
        if isinstance(s, dict):
            return {k: placements(v, mesh) for k, v in s.items()}
        return placements(s, mesh)

    out = {"step": placements(specs["step"], mesh)}
    for key in ("m", "v"):
        out[key] = tree_mod.unflatten_like(
            params_shape, [one(s) for s in tree_mod.flatten_up_to(params_shape, specs[key])])
    return out


# ---------------------------------------------------------------------------
# batch / cache
# ---------------------------------------------------------------------------


def batch_spec(leaf, mesh) -> Tuple:
    dp = dp_axes(mesh)
    return _guard((dp,) + (None,) * (len(leaf.shape) - 1), tuple(leaf.shape), mesh)


def batch_sharding(batch_shape, mesh):
    return tree_mod.map(lambda leaf: placements(batch_spec(leaf, mesh), mesh), batch_shape)


def cache_spec(path, leaf, mesh) -> Tuple:
    """Cache leaves are [G, B, ...]."""
    names = _path_names(path)
    name = names[-1]
    dp = dp_axes(mesh)
    shape = tuple(leaf.shape)
    tp_size = shape_of(mesh)[TP]

    if name in ("k", "v", "xk", "xv"):
        # [G, B, Hkv, cap, dh]
        g, b, hkv, cap, dh = shape
        if hkv % tp_size == 0:
            spec = (None, dp, TP, None, None)
        elif cap % tp_size == 0:
            spec = (None, dp, None, TP, None)  # sequence-sharded (SP decode)
        else:
            spec = (None, dp, None, None, None)
        return _guard(spec, shape, mesh)
    if name == "conv":
        return _guard((None, dp, None, TP), shape, mesh)
    if name == "h":
        if len(shape) == 4:  # mamba [G, B, di, N]
            return _guard((None, dp, TP, None), shape, mesh)
        return _guard((None, dp, TP), shape, mesh)  # slstm [G, B, D]
    if name == "C":
        return _guard((None, dp, None, TP, None), shape, mesh)
    if name == "n":
        if len(shape) == 4:  # mlstm [G, B, H, dh]
            return _guard((None, dp, None, TP), shape, mesh)
        return _guard((None, dp, TP), shape, mesh)
    if name == "m":
        if len(shape) == 3:  # mlstm [G, B, H]
            return _guard((None, dp, None), shape, mesh)
        return _guard((None, dp, TP), shape, mesh)
    if name == "c":
        return _guard((None, dp, TP), shape, mesh)
    return _guard((None, dp), shape, mesh)


def cache_sharding(cache_shape, mesh):
    return tree_mod.map_with_path(
        lambda path, leaf: placements(cache_spec(path, leaf, mesh), mesh), cache_shape)


# ---------------------------------------------------------------------------
# placing trees
# ---------------------------------------------------------------------------


def shard_of(t, placements_seq, mesh):
    """This rank's shard of the whole tensor ``t`` under ``placements_seq``,
    cut out locally (``torch.chunk`` per mesh dim, in mesh-dim order, as
    ``DTensor`` lays shards out): a view where the cut is one piece, else a
    contiguous copy of the shard only."""
    coord = mesh.get_coordinate()
    if coord is None:  # this rank is not in the mesh: it holds nothing
        return t.new_empty((0,) * t.ndim)
    for size, pl, c in zip(mesh.shape, placements_seq, coord):
        if pl.is_shard() and size > 1:
            pieces = torch.chunk(t, size, dim=pl.dim)
            t = pieces[c] if c < len(pieces) else t.narrow(pl.dim, 0, 0)
    return t.contiguous()


def distribute(tree, placements_tree, mesh):
    """Every leaf of ``tree`` (a whole tensor, the same on every rank, as a
    seeded init or a restored checkpoint gives it) as a ``DTensor`` on
    ``mesh`` with its placements. Each rank cuts its own shard out
    (``shard_of``), so nothing is communicated and on a one-rank mesh each
    DTensor wraps the leaf's own storage; the leaves move to the mesh's
    device type first."""
    from torch.distributed.tensor import DTensor

    dev = torch.device(mesh.device_type)
    pl = tree_mod.flatten_up_to(tree, placements_tree)

    def one(t, p):
        t = t.detach().to(dev)
        return DTensor.from_local(shard_of(t, p, mesh), mesh, list(p), run_check=False,
                                  shape=t.shape, stride=t.stride())

    return tree_mod.unflatten_like(tree, [one(t, p) for t, p in zip(tree_mod.leaves(tree), pl)])
