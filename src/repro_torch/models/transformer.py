"""Layer stacking for the dense ``("attention", "dense")`` pattern.

Parameters keep the reference's layout: a tuple with one dict per pattern
position, each leaf stacked over the ``G = n_layers / period`` groups
(``[G, ...]``). Layer ``i`` is group ``i // period`` at position
``i % period``. The reference's ``lax.scan`` over groups is a Python loop.
Cache leaves are ``[G, B, Hkv, cap, dh]`` (batch on axis 1).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L

DENSE = ("attention", "dense")


def _check_pattern(cfg) -> Tuple[Tuple[str, str], ...]:
    pattern = cfg.pattern()
    if any(kinds != DENSE for kinds in pattern):
        raise NotImplementedError(f"only the dense pattern is ported; got {pattern}")
    return pattern


def group_slice(tree, g: int):
    """One layer group's view of a stacked parameter or cache dict."""
    return {k: group_slice(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def init_stack(cfg, gen) -> Tuple[Dict, ...]:
    pattern = _check_pattern(cfg)
    lead = (cfg.n_layers // len(pattern),)
    return tuple(
        {"norm1": L.init_norm(cfg, gen.device, lead),
         "mixer": attn.init_attention(cfg, gen, lead),
         "norm2": L.init_norm(cfg, gen.device, lead),
         "mlp": L.init_dense_mlp(cfg, gen, lead)}
        for _ in pattern)


def init_stack_cache(cfg, batch: int, cap: int, device) -> Tuple[Dict, ...]:
    pattern = _check_pattern(cfg)
    shape = (cfg.n_layers // len(pattern), batch, cfg.n_kv_heads, cap,
             cfg.head_dim)
    dt = cfg.torch_compute_dtype()
    return tuple({"k": torch.zeros(shape, dtype=dt, device=device),
                  "v": torch.zeros(shape, dtype=dt, device=device)}
                 for _ in pattern)


def apply_block(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor,
                causal: bool = True):
    """Prefill through one block. Returns (x, (k, v))."""
    h = L.apply_norm(cfg, p["norm1"], x)
    y, (k, v) = attn.attention_forward(cfg, p["mixer"], h, positions,
                                       causal=causal)
    x = x + y
    h = L.apply_norm(cfg, p["norm2"], x)
    return x + L.apply_dense_mlp(cfg, p["mlp"], h), (k, v)


def apply_block_decode(cfg, p: Dict, x: torch.Tensor, cache: Dict,
                       pos: torch.Tensor) -> torch.Tensor:
    """One decode step through one block; writes the cache in place."""
    h = L.apply_norm(cfg, p["norm1"], x)
    y, _, _ = attn.decode_attention(cfg, p["mixer"], h, cache["k"], cache["v"],
                                    pos)
    x = x + y
    h = L.apply_norm(cfg, p["norm2"], x)
    return x + L.apply_dense_mlp(cfg, p["mlp"], h)


def apply_stack(cfg, stack_params: Tuple[Dict, ...], x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True,
                cache: Optional[Tuple[Dict, ...]] = None) -> torch.Tensor:
    """Prefill through every layer. With ``cache`` (leaves
    ``[G, B, Hkv, cap, dh]``, cap >= S), each layer's k/v are written in
    place into ``[:, :, :, :S]`` of its group, with no stacked copy."""
    pattern = _check_pattern(cfg)
    s = x.shape[1]
    for g in range(cfg.n_layers // len(pattern)):
        for pp in range(len(pattern)):
            x, (k, v) = apply_block(cfg, group_slice(stack_params[pp], g), x,
                                    positions, causal=causal)
            if cache is not None:
                cache[pp]["k"][g, :, :, :s] = k
                cache[pp]["v"][g, :, :, :s] = v
    return x


def apply_stack_decode(cfg, stack_params: Tuple[Dict, ...], x: torch.Tensor,
                       cache: Tuple[Dict, ...], pos: torch.Tensor) -> torch.Tensor:
    """One decode step through every layer; ``pos`` is 0-dim or ``[B]``.
    The cache is updated in place."""
    pattern = _check_pattern(cfg)
    for g in range(cfg.n_layers // len(pattern)):
        for pp in range(len(pattern)):
            x = apply_block_decode(cfg, group_slice(stack_params[pp], g), x,
                                   group_slice(cache[pp], g), pos)
    return x
