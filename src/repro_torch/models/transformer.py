"""Heterogeneous block stacking.

Parameters keep the reference's layout: a tuple with one dict per position
of the config's block pattern, each leaf stacked over the
``G = n_layers / period`` groups (``[G, ...]``). Layer ``i`` is group
``i // period`` at position ``i % period``. The reference's ``lax.scan`` over
groups is a Python loop. Cache leaves carry the batch on axis 1:
``{k, v}`` ``[G, B, Hkv, cap, dh]`` for attention, ``{conv, h}``
``[G, B, K-1, d_inner]`` / ``[G, B, d_inner, N]`` for mamba.

Mixers: ``attention`` and ``mamba``; MLPs: ``dense``, ``moe`` and ``none``.
The xLSTM mixers and cross-attention come with later slices.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod

MIXERS = ("attention", "mamba")
MLPS = ("dense", "moe", "none")


def _check_pattern(cfg) -> Tuple[Tuple[str, str], ...]:
    pattern = cfg.pattern()
    for mixer, mlp in pattern:
        if mixer not in MIXERS or mlp not in MLPS:
            raise NotImplementedError(
                f"block ({mixer}, {mlp}) is not ported yet; got {pattern}")
    if cfg.encoder_decoder:
        raise NotImplementedError("cross-attention is not ported yet")
    return pattern


def group_slice(tree, g: int):
    """One layer group's view of a stacked parameter or cache dict."""
    return {k: group_slice(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def init_block(cfg, gen, kinds: Tuple[str, str], lead: Tuple[int, ...] = ()) -> Dict:
    mixer_kind, mlp_kind = kinds
    p: Dict = {"norm1": L.init_norm(cfg, gen.device, lead)}
    if mixer_kind == "attention":
        p["mixer"] = attn.init_attention(cfg, gen, lead)
    else:
        p["mixer"] = ssm_mod.init_mamba(cfg, gen, lead)
    if mlp_kind == "dense":
        p["norm2"] = L.init_norm(cfg, gen.device, lead)
        p["mlp"] = L.init_dense_mlp(cfg, gen, lead)
    elif mlp_kind == "moe":
        p["norm2"] = L.init_norm(cfg, gen.device, lead)
        p["mlp"] = moe_mod.init_moe(cfg, gen, lead)
    return p


def init_block_cache(cfg, mixer_kind: str, batch: int, cap: int, device,
                     lead: Tuple[int, ...] = ()) -> Dict:
    """Zeroed decode cache for one block (stacked over ``lead``)."""
    dt = cfg.torch_compute_dtype()
    if mixer_kind == "attention":
        shape = lead + (batch, cfg.n_kv_heads, cap, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    return ssm_mod.init_mamba_cache(cfg, batch, dt, device, lead)


def _apply_mlp(cfg, p, mlp_kind, x):
    """Returns (x, the MoE aux loss or None): a block without MoE launches
    nothing for an aux loss."""
    if mlp_kind == "none":
        return x, None
    h = L.apply_norm(cfg, p["norm2"], x)
    if mlp_kind == "dense":
        return x + L.apply_dense_mlp(cfg, p["mlp"], h), None
    y, aux = moe_mod.apply_moe(cfg, p["mlp"], h)
    return x + y, aux


def apply_block(cfg, p: Dict, kinds: Tuple[str, str], x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True):
    """Prefill through one block. Returns (x, cache_contrib, MoE aux loss or
    None):
    attention's ``{k, v}`` ``[B, Hkv, S, dh]`` or mamba's final
    ``{conv, h}``."""
    mixer_kind, mlp_kind = kinds
    h = L.apply_norm(cfg, p["norm1"], x)
    if mixer_kind == "attention":
        with L.span("attention"):
            y, (k, v) = attn.attention_forward(cfg, p["mixer"], h, positions,
                                               causal=causal)
        contrib = {"k": k, "v": v}
    else:
        with L.span("mamba"):
            y, contrib = ssm_mod.mamba_forward(cfg, p["mixer"], h,
                                               return_state=True)
    x, aux = _apply_mlp(cfg, p, mlp_kind, x + y)
    return x, contrib, aux


def apply_block_decode(cfg, p: Dict, kinds: Tuple[str, str], x: torch.Tensor,
                       cache: Dict, pos: torch.Tensor) -> torch.Tensor:
    """One decode step through one block; writes the cache in place."""
    mixer_kind, mlp_kind = kinds
    h = L.apply_norm(cfg, p["norm1"], x)
    if mixer_kind == "attention":
        with L.span("attention"):
            y, _, _ = attn.decode_attention(cfg, p["mixer"], h, cache["k"],
                                            cache["v"], pos)
    else:
        with L.span("mamba"):
            y, st = ssm_mod.mamba_decode(cfg, p["mixer"], h, cache)
            cache["conv"].copy_(st["conv"])
            cache["h"].copy_(st["h"])
    x, _ = _apply_mlp(cfg, p, mlp_kind, x + y)
    return x


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------


def init_stack(cfg, gen) -> Tuple[Dict, ...]:
    pattern = _check_pattern(cfg)
    lead = (cfg.n_layers // len(pattern),)
    return tuple(init_block(cfg, gen, kinds, lead) for kinds in pattern)


def init_stack_cache(cfg, batch: int, cap: int, device) -> Tuple[Dict, ...]:
    pattern = _check_pattern(cfg)
    lead = (cfg.n_layers // len(pattern),)
    return tuple(init_block_cache(cfg, mixer, batch, cap, device, lead)
                 for mixer, _ in pattern)


def apply_stack(cfg, stack_params: Tuple[Dict, ...], x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True,
                cache: Optional[Tuple[Dict, ...]] = None):
    """Prefill through every layer. Returns (x, summed MoE aux loss). With
    ``cache`` (from ``init_stack_cache``, attention cap >= S), each
    attention layer's k/v are written in place into ``[:, :, :, :S]`` of its
    group and each mamba layer's final state into its group, with no
    stacked copy."""
    pattern = _check_pattern(cfg)
    s = x.shape[1]
    aux = torch.zeros((), device=x.device)
    for g in range(cfg.n_layers // len(pattern)):
        for pp, kinds in enumerate(pattern):
            x, contrib, a = apply_block(cfg, group_slice(stack_params[pp], g),
                                        kinds, x, positions, causal=causal)
            if a is not None:
                aux = aux + a
            if cache is None:
                continue
            for key, val in contrib.items():
                leaf = cache[pp][key][g]
                if kinds[0] == "attention":
                    leaf = leaf[:, :, :s]
                leaf.copy_(val)
    return x, aux


def apply_stack_decode(cfg, stack_params: Tuple[Dict, ...], x: torch.Tensor,
                       cache: Tuple[Dict, ...], pos: torch.Tensor) -> torch.Tensor:
    """One decode step through every layer; ``pos`` is 0-dim or ``[B]``
    (mamba layers are position-free recurrences). The cache is updated in
    place."""
    pattern = _check_pattern(cfg)
    for g in range(cfg.n_layers // len(pattern)):
        for pp, kinds in enumerate(pattern):
            x = apply_block_decode(cfg, group_slice(stack_params[pp], g), kinds,
                                   x, group_slice(cache[pp], g), pos)
    return x
