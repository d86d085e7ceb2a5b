"""Heterogeneous block stacking.

Parameters keep the reference's layout: a tuple with one dict per position
of the block pattern, each leaf stacked over the ``G = n_layers / period``
groups (``[G, ...]``). Layer ``i`` is group ``i // period`` at position
``i % period``. The reference's ``lax.scan`` over groups is a Python loop.
Cache leaves carry the batch on axis 1: ``{k, v}`` ``[G, B, Hkv, cap, dh]``
for attention, ``{conv, h}`` for mamba, ``{C, n, m}`` for mLSTM and ``{c,
n, h, m}`` for sLSTM; a block with cross-attention adds ``{xk, xv}``
``[G, B, Hkv, cross_len, dh]``.

Mixers: ``attention``, ``mamba``, ``mlstm`` and ``slstm``; MLPs: ``dense``,
``moe`` and ``none``. The stack's pattern is the config's unless a caller
passes one (the encoder's is ``(("attention", "dense"),)``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as sh

MIXERS = ("attention", "mamba", "mlstm", "slstm")
MLPS = ("dense", "moe", "none")


# each mixer's parameter init, and the recurrent mixers' prefill and decode
_INIT = {"attention": attn.init_attention, "mamba": ssm_mod.init_mamba,
         "mlstm": xlstm_mod.init_mlstm, "slstm": xlstm_mod.init_slstm}
_FORWARD = {"mamba": ssm_mod.mamba_forward, "mlstm": xlstm_mod.mlstm_forward,
            "slstm": xlstm_mod.slstm_forward}
_DECODE = {"mamba": ssm_mod.mamba_decode, "mlstm": xlstm_mod.mlstm_decode,
           "slstm": xlstm_mod.slstm_decode}


def _check_pattern(cfg, pattern=None) -> Tuple[Tuple[str, str], ...]:
    pattern = pattern or cfg.pattern()
    for mixer, mlp in pattern:
        if mixer not in MIXERS or mlp not in MLPS:
            raise ValueError(f"unknown block ({mixer}, {mlp}) in {pattern}")
    return pattern


def group_views(tree) -> List[Dict]:
    """Every layer group's view of a stacked parameter or cache dict, taken
    with one ``unbind(0)`` per leaf. Under autograd a leaf's ``unbind``
    stacks its group gradients once in the backward, where a select per
    group would allocate a zero tensor the size of the whole leaf for each
    group. The views share the leaf's storage, so a cache written in place
    through them is written in the stacked leaf."""
    split = {k: group_views(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(split.values())))
    return [{k: split[k][g] for k in split} for g in range(n)]


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def init_block(cfg, gen, kinds: Tuple[str, str], lead: Tuple[int, ...] = (),
               cross: bool = False) -> Dict:
    """One block's parameters; ``cross`` adds the cross-attention's
    ``norm_x`` and ``xattn``."""
    mixer_kind, mlp_kind = kinds
    dev = gen.device
    p: Dict = {"norm1": L.init_norm(cfg, dev, lead),
               "mixer": _INIT[mixer_kind](cfg, gen, lead)}
    if cross:
        p["norm_x"] = L.init_norm(cfg, dev, lead)
        p["xattn"] = attn.init_attention(cfg, gen, lead)
    if mlp_kind == "dense":
        p["norm2"] = L.init_norm(cfg, dev, lead)
        p["mlp"] = L.init_dense_mlp(cfg, gen, lead)
    elif mlp_kind == "moe":
        p["norm2"] = L.init_norm(cfg, dev, lead)
        p["mlp"] = moe_mod.init_moe(cfg, gen, lead)
    return p


def init_block_cache(cfg, mixer_kind: str, batch: int, cap: int, device,
                     lead: Tuple[int, ...] = (), cross_len: int = 0) -> Dict:
    """Zeroed decode cache for one block (stacked over ``lead``); with
    ``cross_len`` also the cross-attention's ``{xk, xv}``."""
    dt = cfg.torch_compute_dtype()
    kv = lambda n: torch.zeros(lead + (batch, cfg.n_kv_heads, n, cfg.head_dim),
                               dtype=dt, device=device)
    if mixer_kind == "attention":
        c = {"k": kv(cap), "v": kv(cap)}
    elif mixer_kind == "mamba":
        c = ssm_mod.init_mamba_cache(cfg, batch, dt, device, lead)
    elif mixer_kind == "mlstm":
        c = xlstm_mod.init_mlstm_cache(cfg, batch, device, lead)
    else:
        c = xlstm_mod.init_slstm_cache(cfg, batch, device, lead)
    if cross_len:
        c.update(xk=kv(cross_len), xv=kv(cross_len))
    return c


def _apply_mlp(cfg, p, mlp_kind, x):
    """Returns (x, the MoE aux loss or None): a block without MoE launches
    nothing for an aux loss. The dense MLP is a ``pctx.region`` that places
    its output like ``x``; the MoE takes its tokens whole."""
    if mlp_kind == "none":
        return x, None
    h = L.apply_norm(cfg, p["norm2"], x)
    if mlp_kind == "dense":
        return x + L.apply_dense_mlp(cfg, p["mlp"], h), None
    y, aux = moe_mod.apply_moe(cfg, p["mlp"], pctx.whole_tokens(h))
    return pctx.residual(x, y), aux


def apply_block(cfg, p: Dict, kinds: Tuple[str, str], x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True,
                enc_out: Optional[torch.Tensor] = None, with_cache: bool = True):
    """Prefill through one block. Returns (x, cache_contrib, MoE aux loss or
    None): attention's ``{k, v}`` ``[B, Hkv, S, dh]`` (``None`` each without
    ``with_cache``) or a recurrent mixer's final state, and with ``enc_out``
    (and cross-attention parameters) the encoder's projections ``{xk,
    xv}``."""
    mixer_kind, mlp_kind = kinds
    # sequence-parallel activations are normed on their shards; attention
    # is a region that gathers them and places its output like ``x``, the
    # recurrent mixers take them whole
    h = L.apply_norm(cfg, p["norm1"], x)
    with L.span(mixer_kind):
        if mixer_kind == "attention":
            y, (k, v) = attn.attention_forward(cfg, p["mixer"], h, positions,
                                               causal=causal, with_kv=with_cache)
            contrib = {"k": k, "v": v}
            x = x + y
        else:
            y, contrib = _FORWARD[mixer_kind](cfg, p["mixer"], pctx.whole_tokens(h),
                                              return_state=True)
            x = pctx.residual(x, y)
    if enc_out is not None and "xattn" in p:
        hx = L.apply_norm(cfg, p["norm_x"], x)
        with L.span("cross_attention"):
            y, (xk, xv) = attn.attention_forward(cfg, p["xattn"], hx, positions,
                                                 causal=False, kv_x=enc_out,
                                                 use_rope=False)
        contrib = dict(contrib, xk=xk, xv=xv)
        x = x + y
    x, aux = _apply_mlp(cfg, p, mlp_kind, x)
    return x, contrib, aux


def apply_block_decode(cfg, p: Dict, kinds: Tuple[str, str], x: torch.Tensor,
                       cache: Dict, pos: torch.Tensor) -> torch.Tensor:
    """One decode step through one block; writes the cache in place (the
    cross-attention's ``{xk, xv}`` are read, never written)."""
    mixer_kind, mlp_kind = kinds
    h = L.apply_norm(cfg, p["norm1"], x)
    with L.span(mixer_kind):
        if mixer_kind == "attention":
            y, _, _ = attn.decode_attention(cfg, p["mixer"], h, cache["k"],
                                            cache["v"], pos)
        else:
            y, st = _DECODE[mixer_kind](cfg, p["mixer"], h, cache)
            for key, val in st.items():
                sh.write_along(cache[key], val)
    x = pctx.residual(x, y)
    if "xattn" in p:
        hx = L.apply_norm(cfg, p["norm_x"], x)
        with L.span("cross_attention"):
            y, _, _ = attn.decode_attention(cfg, p["xattn"], hx, cache["xk"],
                                            cache["xv"], pos, cross=True)
        x = pctx.residual(x, y)
    x, _ = _apply_mlp(cfg, p, mlp_kind, x)
    return x


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------


def init_stack(cfg, gen, n_layers: Optional[int] = None, cross: bool = False,
               pattern: Optional[Tuple[Tuple[str, str], ...]] = None) -> Tuple[Dict, ...]:
    """A tuple with one parameter dict per pattern position, each leaf
    stacked over ``G = n_layers / period`` groups (``n_layers`` defaults to
    the config's, ``pattern`` to the config's)."""
    pattern = _check_pattern(cfg, pattern)
    n_layers = n_layers or cfg.n_layers
    if n_layers % len(pattern):
        raise ValueError(f"{n_layers} layers do not split into periods of {len(pattern)}")
    lead = (n_layers // len(pattern),)
    return tuple(init_block(cfg, gen, kinds, lead, cross=cross) for kinds in pattern)


def init_stack_cache(cfg, batch: int, cap: int, device, n_layers: Optional[int] = None,
                     cross_len: int = 0,
                     pattern: Optional[Tuple[Tuple[str, str], ...]] = None) -> Tuple[Dict, ...]:
    pattern = _check_pattern(cfg, pattern)
    lead = ((n_layers or cfg.n_layers) // len(pattern),)
    return tuple(init_block_cache(cfg, mixer, batch, cap, device, lead,
                                  cross_len=cross_len)
                 for mixer, _ in pattern)


def apply_stack(cfg, stack_params: Tuple[Dict, ...], x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True,
                cache: Optional[Tuple[Dict, ...]] = None,
                enc_out: Optional[torch.Tensor] = None,
                pattern: Optional[Tuple[Tuple[str, str], ...]] = None):
    """Prefill (or the training forward) through every layer of the stack
    (its depth is the parameters' group count). Returns (x, summed MoE aux
    loss). With ``cache`` (from ``init_stack_cache``, attention cap >= S),
    each layer's contribution is written in place into its group, with no
    stacked copy: self-attention's k/v into ``[:, :, :, :S]`` of the
    ``k``/``v`` leaves, every other leaf (recurrent states,
    cross-attention's ``xk``/``xv``) whole. Under autograd with
    ``cfg.remat_stack`` each group's activations are recomputed in the
    backward, as the reference's ``nothing_saveable`` policy does."""
    pattern = _check_pattern(cfg, pattern)
    aux = torch.zeros((), device=x.device)
    views = [group_views(sp) for sp in stack_params]

    def run_group(g, x):
        aux_g, contribs = None, []
        x = pctx.constrain_tokens(x)
        for pp, kinds in enumerate(pattern):
            x, contrib, a = apply_block(cfg, views[pp][g], kinds, x, positions,
                                        causal=causal, enc_out=enc_out,
                                        with_cache=cache is not None)
            x = pctx.constrain_tokens(x)
            if a is not None:
                aux_g = a if aux_g is None else aux_g + a
            contribs.append(contrib)
        return x, aux_g, contribs

    for g in range(len(views[0])):
        if cfg.remat_stack and cache is None:
            x, a = L.remat(lambda x, g=g: run_group(g, x)[:2], x)
        else:
            x, a, contribs = run_group(g, x)
        if a is not None:
            aux = aux + a
        if cache is None:
            continue
        for pp, contrib in enumerate(contribs):
            for key, val in contrib.items():
                sh.write_along(cache[pp][key][g], val, 2 if key in ("k", "v") else None)
    return x, aux


def apply_stack_decode(cfg, stack_params: Tuple[Dict, ...], x: torch.Tensor,
                       cache: Tuple[Dict, ...], pos: torch.Tensor) -> torch.Tensor:
    """One decode step through every layer; ``pos`` is 0-dim or ``[B]``
    (the recurrent mixers are position-free). The cache is updated in
    place."""
    pattern = _check_pattern(cfg)
    views = [group_views(sp) for sp in stack_params]
    caches = [group_views(c) for c in cache]
    for g in range(len(views[0])):
        for pp, kinds in enumerate(pattern):
            x = apply_block_decode(cfg, views[pp][g], kinds, x, caches[pp][g], pos)
    return x
