"""GQA attention: prefill (the flash kernel below ``chunked_threshold``,
chunked plain torch at or above it) and single-token decode over a KV cache.
Cross-attention (keys and values from the encoder's output) goes through
the chunked plain path at any length, as in the reference, and decodes over
the encoder's projections with no cache write.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as sh

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


def _product(p, w: str, xc):
    """xc @ p[w] in xc's (the compute) dtype, plus the bias ``b<w[1]>``
    where the layer has one."""
    cd = xc.dtype
    y = xc @ p[w].to(cd)
    bias = "b" + w[1]
    return y + p[bias].to(cd) if bias in p else y


def _qkv_products(p, xc, kv_xc=None):
    """x @ wq and kv_x @ wk, kv_x @ wv (kv_x defaults to x) in the compute
    dtype, each plus its bias where the layer has one (before the reshape
    into heads and RoPE)."""
    kv_xc = xc if kv_xc is None else kv_xc
    return _product(p, "wq", xc), _product(p, "wk", kv_xc), _product(p, "wv", kv_xc)


def _project_qkv(cfg, p, x, kv_x=None):
    """x [B,S,D] (and kv_x [B,Skv,D], default x) -> q [B,H,S,dh], k/v
    [B,Hkv,Skv,dh]."""
    cd = cfg.torch_compute_dtype()
    b, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    skv = kv_x.shape[1]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv_products(p, x.to(cd), kv_x.to(cd))
    q = q.reshape(b, s, h, dh).transpose(1, 2)
    k = k.reshape(b, skv, hkv, dh).transpose(1, 2)
    v = v.reshape(b, skv, hkv, dh).transpose(1, 2)
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


def _local_kv(k, v, first: int, n: int, g: int):
    """The key/value heads of query heads ``[first, first + n)`` out of
    whole ``k``/``v`` (query head i reads key head i // g), as a GQA layout
    of its own: a slice of n / g heads, one head for a group wider than
    ``n``, else each head repeated per query head."""
    if n % g == 0:
        sl = slice(first // g, first // g + n // g)
    elif g % n == 0 and first // g == (first + n - 1) // g:
        sl = slice(first // g, first // g + 1)
    else:
        idx = torch.arange(first, first + n, device=k.device) // g
        return k[:, idx].contiguous(), v[:, idx].contiguous()
    return k[:, sl].contiguous(), v[:, sl].contiguous()


def head_parallel(attend, q, k, v):
    """``attend(q, k, v)``; on DTensors, per rank on its local shards
    (``local_map``), so the kernel sees raw tensors and launches on each
    rank's heads. The batch goes over the mesh's DP axes and the heads over
    ``model`` where the query heads divide; the key/value heads go with
    them where they divide too, else stay whole and each rank takes its
    query heads' own (``_local_kv``), their gradients summed over
    ``model``."""
    from torch.distributed.tensor import DTensor, Partial

    if not isinstance(q, DTensor):
        return attend(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    names, shape = mesh_mod.axis_names(mesh), mesh_mod.shape_of(mesh)
    dp = mesh_mod.dp_axes(mesh)
    hq, hkv = q.shape[1], k.shape[1]
    tp = shape.get(sh.TP, 1)
    q_heads = sh.TP if sh.TP in names and hq % tp == 0 else None
    kv_heads = q_heads if q_heads and hkv % tp == 0 else None
    qp = sh.placements(sh.P(dp, q_heads), mesh)
    kvp = sh.placements(sh.P(dp, kv_heads), mesh)
    kv_grad = kvp
    if q_heads and not kv_heads:
        kv_grad = tuple(Partial() if a == sh.TP else p for a, p in zip(names, kvp))
    q, k, v = (t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
               for t, pl in ((q, qp), (k, kvp), (v, kvp)))

    def local(ql, kl, vl):
        if q_heads and not kv_heads:
            n = hq // tp
            kl, vl = _local_kv(kl, vl, mesh.get_local_rank(sh.TP) * n, n, hq // hkv)
        return attend(ql, kl, vl)

    return local_map(local, out_placements=list(qp), in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


def attention_forward(
    cfg,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
    kv_x: Optional[torch.Tensor] = None,
    use_rope: bool = True,
    chunked_threshold: int = 4096,
):
    """Self (or, with ``kv_x``, cross) attention for prefill. RoPE applies
    to self attention with ``use_rope`` only. Returns (output [B,S,D],
    (k, v) for the cache)."""
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    if use_rope and kv_x is None:
        sin, cos = L.rope_tables(cfg, positions)  # [S, dh/2] — broadcasts
        q, k = L.apply_rope(q, sin, cos), L.apply_rope(k, sin, cos)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    s = q.shape[2]
    if kv_x is not None:
        attend = lambda q, k, v: chunked_attention(q, k, v, causal=False,
                                                   chunk=cfg.attn_chunk)
    elif s >= chunked_threshold:
        attend = lambda q, k, v: chunked_attention(q, k, v, causal=causal,
                                                   chunk=cfg.attn_chunk)
    else:
        attend = lambda q, k, v: kops.attention(q, k, v, causal=causal)
    out = head_parallel(attend, q, k, v)
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
    cross: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention over the cache; returns (y, cache_k, cache_v).

    The new token's k/v are written into ``cache_k``/``cache_v`` in place
    (saving a copy of the whole cache per layer and step) and the same
    tensors are returned. A 0-dim ``pos`` puts every row at one depth; a
    ``[B]`` ``pos`` gives each row its own RoPE angle, cache write index and
    validity mask. ``pos < CAP`` is the caller's precondition
    (``Model.decode_step`` checks it). With ``cross`` the cache is the
    encoder's projections: no RoPE, no write, every position valid."""
    cd = cfg.torch_compute_dtype()
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hkv
    if cross:
        q = _product(p, "wq", x.to(cd)).reshape(b, hkv, g, dh)
        return _attend(cfg, p, q, cache_k, cache_v, None).to(x.dtype), cache_k, cache_v
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
    idx = torch.arange(cache_k.shape[2], device=x.device)
    if vector_pos:
        valid = (idx[None, :] <= pos[:, None])[:, None, None]  # [B,1,1,cap]
    else:
        valid = idx <= pos
    y = _attend(cfg, p, q.reshape(b, hkv, g, dh), cache_k, cache_v, valid)
    return y.to(x.dtype), cache_k, cache_v


def _attend(cfg, p, q, cache_k, cache_v, valid):
    """q [B, Hkv, G, dh] over the cache (positions outside ``valid`` masked;
    ``None``: all valid), in f32, then the output projection -> [B, 1, D]
    in the compute dtype."""
    cd = cfg.torch_compute_dtype()
    b, hkv, g, dh = q.shape
    logits = torch.einsum("bhgd,bhkd->bhgk", q.float() * (dh ** -0.5), cache_k.float())
    if valid is not None:
        logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", w, cache_v.float())
    return out.reshape(b, 1, hkv * g * dh).to(cd) @ p["wo"].to(cd)
