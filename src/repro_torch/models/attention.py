"""GQA attention: prefill (the flash kernel below ``chunked_threshold``,
chunked plain torch at or above it) and single-token decode over a KV cache.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

NEG_INF = -1e30


def init_attention(cfg, gen, lead: Tuple[int, ...] = ()) -> Dict:
    """``wq/wk/wv/wo``, and with ``cfg.qkv_bias`` the biases ``bq/bk/bv``
    (zeros, as the reference draws them)."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.torch_param_dtype()
    sc = d ** -0.5
    p = {
        "wq": L.normal(gen, lead + (d, h * dh), sc, dt),
        "wk": L.normal(gen, lead + (d, hkv * dh), sc, dt),
        "wv": L.normal(gen, lead + (d, hkv * dh), sc, dt),
        "wo": L.normal(gen, lead + (h * dh, d), (h * dh) ** -0.5, dt),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros(lead + (h * dh,), dtype=dt, device=dev)
        p["bk"] = torch.zeros(lead + (hkv * dh,), dtype=dt, device=dev)
        p["bv"] = torch.zeros(lead + (hkv * dh,), dtype=dt, device=dev)
    return p


def _qkv_products(p, xc):
    """x @ wq, x @ wk, x @ wv in the compute dtype, each plus its bias where
    the layer has one (before the reshape into heads and RoPE)."""
    cd = xc.dtype
    q, k, v = (xc @ p[w].to(cd) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = q + p["bq"].to(cd), k + p["bk"].to(cd), v + p["bv"].to(cd)
    return q, k, v


def _project_qkv(cfg, p, x):
    """x [B,S,D] -> q [B,H,S,dh], k/v [B,Hkv,S,dh]."""
    cd = cfg.torch_compute_dtype()
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv_products(p, x.to(cd))
    q = q.reshape(b, s, h, dh).transpose(1, 2)
    k = k.reshape(b, s, hkv, dh).transpose(1, 2)
    v = v.reshape(b, s, hkv, dh).transpose(1, 2)
    return q, k, v


def chunked_attention(
    q: torch.Tensor,  # [B,H,S,dh]
    k: torch.Tensor,  # [B,Hkv,Skv,dh]
    v: torch.Tensor,
    causal: bool,
    chunk: int = 512,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks in plain torch (the long-prompt
    path). Scores/softmax run in f32; both products take operands in the
    compute dtype with f32 accumulation."""
    b, h, s, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    cd = q.dtype
    qg = (q.float() * (dh ** -0.5)).to(cd).reshape(b, hkv, g, s, dh).float()
    c = min(chunk, skv)
    while skv % c:
        c //= 2
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, hkv, g, s), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, s, dh), device=q.device)
    for c0 in range(0, skv, c):
        ki = k[:, :, c0:c0 + c].float()
        vi = v[:, :, c0:c0 + c].float()
        s_ij = torch.einsum("bhgqd,bhkd->bhgqk", qg, ki)
        if causal:
            k_pos = c0 + torch.arange(c, device=q.device)
            s_ij = s_ij.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
        m_new = torch.maximum(m, s_ij.amax(-1))
        p_ij = torch.exp(s_ij - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p_ij.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p_ij.to(cd).float(), vi)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, s, dh).to(q.dtype)


def attention_forward(
    cfg,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
    chunked_threshold: int = 4096,
):
    """Self attention for prefill. Returns (output [B,S,D], (k, v) for the
    cache)."""
    q, k, v = _project_qkv(cfg, p, x)
    sin, cos = L.rope_tables(cfg, positions)  # [S, dh/2] — broadcasts
    q = L.apply_rope(q, sin, cos).contiguous()
    k = L.apply_rope(k, sin, cos).contiguous()
    v = v.contiguous()
    s = q.shape[2]
    if s >= chunked_threshold:
        out = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    else:
        out = kops.attention(q, k, v, causal=causal)
    b = x.shape[0]
    cd = cfg.torch_compute_dtype()
    merged = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    y = merged.to(cd) @ p["wo"].to(cd)
    return y.to(x.dtype), (k, v)


def decode_attention(
    cfg,
    p: Dict,
    x: torch.Tensor,  # [B, 1, D]
    cache_k: torch.Tensor,  # [B, Hkv, CAP, dh]
    cache_v: torch.Tensor,
    pos: torch.Tensor,  # 0-dim (lockstep) or [B] (per-slot depths), < CAP
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention over the cache; returns (y, cache_k, cache_v).

    The new token's k/v are written into ``cache_k``/``cache_v`` in place
    (saving a copy of the whole cache per layer and step) and the same
    tensors are returned. A 0-dim ``pos`` puts every row at one depth; a
    ``[B]`` ``pos`` gives each row its own RoPE angle, cache write index and
    validity mask. ``pos < CAP`` is the caller's precondition
    (``Model.decode_step`` checks it)."""
    cd = cfg.torch_compute_dtype()
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hkv
    cap = cache_k.shape[2]
    vector_pos = pos.ndim == 1
    q, knew, vnew = _qkv_products(p, x.to(cd))
    q = q.reshape(b, h, 1, dh)
    knew = knew.reshape(b, hkv, 1, dh)
    vnew = vnew.reshape(b, hkv, 1, dh)
    if vector_pos:
        # per-row tables [B, 1, dh/2], lifted to [B, 1, 1, dh/2] so they
        # broadcast over the head axis
        sin, cos = L.rope_tables(cfg, pos[:, None])
        sin, cos = sin[:, None], cos[:, None]
    else:
        sin, cos = L.rope_tables(cfg, pos[None])  # [1, dh/2]
    q = L.apply_rope(q, sin, cos).reshape(b, h, dh)
    knew = L.apply_rope(knew, sin, cos)
    if vector_pos:
        rows, at = torch.arange(b, device=x.device), pos.long()
        cache_k[rows, :, at] = knew[:, :, 0].to(cache_k.dtype)
        cache_v[rows, :, at] = vnew[:, :, 0].to(cache_v.dtype)
    else:
        idx = pos.reshape(1).long()
        cache_k.index_copy_(2, idx, knew.to(cache_k.dtype))
        cache_v.index_copy_(2, idx, vnew.to(cache_v.dtype))

    qg = q.reshape(b, hkv, g, dh).float() * (dh ** -0.5)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, cache_k.float())
    idx = torch.arange(cap, device=x.device)
    if vector_pos:
        valid = (idx[None, :] <= pos[:, None])[:, None, None]  # [B,1,1,cap]
    else:
        valid = idx <= pos
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", w, cache_v.float())
    y = out.reshape(b, 1, h * dh).to(cd) @ p["wo"].to(cd)
    return y.to(x.dtype), cache_k, cache_v
