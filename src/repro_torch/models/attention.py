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
from repro_torch.models import layers as L
from repro_torch.parallel import context as pctx
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


def _whole_heads(t, heads: int):
    """``t`` [..., heads * dh] ready for the split into heads: on a DTensor
    whose last dim is sharded over mesh dims whose ranks do not divide
    ``heads`` (the head-aware rules replicate such a projection's columns,
    but DTensor's propagation may shard its output anyway), those mesh dims
    take ``Replicate()``, so each rank holds whole heads. A plain tensor,
    or one whose shards hold whole heads, is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    last = t.ndim - 1
    split = [i for i, pl in enumerate(t.placements) if pl.is_shard(last)]
    n = 1
    for i in split:
        n *= t.device_mesh.size(i)
    if heads % n == 0:
        return t
    pl = [Replicate() if i in split else p for i, p in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, pl)


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


def _heads(cfg, p, x, kv_x, positions, use_rope: bool, heads: int, kv_heads: int):
    """q [B, heads, S, dh] and k/v [B, kv_heads, Skv, dh] from x [B, S, D]
    and kv_x [B, Skv, D] through the projections ``p`` (whole, or a rank's
    column shard of whole heads), with RoPE where ``use_rope``."""
    cd = cfg.torch_compute_dtype()
    b, s, _ = x.shape
    skv, dh = kv_x.shape[1], cfg.head_dim
    q, k, v = _qkv_products(p, x.to(cd), kv_x.to(cd))
    q = q.reshape(b, s, heads, dh).transpose(1, 2)
    k = k.reshape(b, skv, kv_heads, dh).transpose(1, 2)
    v = v.reshape(b, skv, kv_heads, dh).transpose(1, 2)
    if use_rope:
        sin, cos = L.rope_tables(cfg, positions)  # [S, dh/2] — broadcasts
        q, k = L.apply_rope(q, sin, cos), L.apply_rope(k, sin, cos)
    return q.contiguous(), k.contiguous(), v.contiguous()


def attention_forward(
    cfg,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
    kv_x: Optional[torch.Tensor] = None,
    use_rope: bool = True,
    chunked_threshold: int = 4096,
    with_kv: bool = True,
):
    """Self (or, with ``kv_x``, cross) attention for prefill. RoPE applies
    to self attention with ``use_rope`` only. Returns (output [B,S,D],
    (k, v) for the cache; ``(None, None)`` where ``with_kv`` is off).

    On a mesh the whole block part is one ``pctx.region``, token-gathered:
    the tokens (and ``kv_x``) gathered over their sequence shards, and where
    the query heads divide ``model`` each rank projects, attends (the
    kernel on raw tensors) and projects out its own heads, ``wo``'s rows
    leaving a partial sum; the key/value heads go with them where they
    divide too, else each rank takes its query heads' own (``_local_kv``),
    projecting only those unless the cache needs them all (``with_kv``).
    The weight-gathered layout would keep the queries on their sequence
    shards, but the keys and values need every position and the flash
    kernel has no argument for the queries' offset in the causal mask, so
    attention stays token-gathered."""
    s = x.shape[1]
    rope = use_rope and kv_x is None
    if kv_x is not None:
        attend = lambda q, k, v: chunked_attention(q, k, v, causal=False,
                                                   chunk=cfg.attn_chunk)
    elif s >= chunked_threshold:
        attend = lambda q, k, v: chunked_attention(q, k, v, causal=causal,
                                                   chunk=cfg.attn_chunk)
    else:
        attend = lambda q, k, v: kops.attention(q, k, v, causal=causal)
    names = sorted(k for k in p if k != "wo")
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hkv
    tp = pctx.tp_size(x.device_mesh) if pctx.is_dtensor(x) else 1
    q_split = h % tp == 0
    kv_split = q_split and hkv % tp == 0
    n = h // tp if q_split else h
    first = n * x.device_mesh.get_local_rank(sh.TP) if q_split and tp > 1 else 0
    # the key/value heads this rank projects: its own share, all of them,
    # or (its query heads' own) a range of them
    if kv_split:
        kv0, kv1 = first // g, first // g + n // g
    elif with_kv:
        kv0, kv1 = 0, hkv
    else:
        kv0, kv1 = first // g, (first + n - 1) // g + 1
    tokens = (x,) if kv_x is None else (x, kv_x)

    def local(*args):
        x, kv_x = args[0], args[len(tokens) - 1]
        wo, w = args[len(tokens)], dict(zip(names, args[len(tokens) + 1:]))
        if not kv_split and (kv0, kv1) != (0, hkv):
            cols = slice(kv0 * dh, kv1 * dh)
            w.update({k: w[k][..., cols] for k in ("wk", "wv", "bk", "bv") if k in w})
        q, k, v = _heads(cfg, w, x, kv_x, positions, rope, n, kv1 - kv0)
        kl, vl = (k, v) if (kv1 - kv0) * g == n else _local_kv(k, v, first - kv0 * g, n, g)
        out = attend(q, kl, vl)
        cd = cfg.torch_compute_dtype()
        merged = out.transpose(1, 2).reshape(x.shape[0], s, n * dh)
        y = (merged.to(cd) @ wo.to(cd)).to(x.dtype)
        return (y, k, v) if with_kv else y

    # a projection's columns (a bias's entries) split with its heads
    split_of = {"wq": q_split, "bq": q_split, "wk": kv_split, "bk": kv_split,
                "wv": kv_split, "bv": kv_split}
    weights = [(p["wo"], 0)] + [(p[k], p[k].ndim - 1 if split_of[k] else None)
                                for k in names]
    kv_dim = 1 if kv_split else None
    outs = (pctx.ROW_SUM, kv_dim, kv_dim) if with_kv else (pctx.ROW_SUM,)
    out = pctx.region(local, tokens, weights, split=q_split, outs=outs)
    return (out[0], out[1:]) if with_kv else (out, (None, None))


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
        q = _whole_heads(_product(p, "wq", x.to(cd)), hkv).reshape(b, hkv, g, dh)
        if pctx.is_dtensor(cache_k):
            y = _project_out(cfg, p, _decode_sharded(q, None, None, cache_k, cache_v, None))
            return y.to(x.dtype), cache_k, cache_v
        return _attend(cfg, p, q, cache_k, cache_v, None).to(x.dtype), cache_k, cache_v
    vector_pos = pos.ndim == 1
    if vector_pos and pctx.is_dtensor(cache_k):
        raise ValueError("per-slot decode positions need a plain cache, not a DTensor one")
    q, knew, vnew = _qkv_products(p, x.to(cd))
    # q splits into [hkv, g] below, so its shards hold whole key-head groups
    q, knew, vnew = (_whole_heads(t, hkv) for t in (q, knew, vnew))
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
    if pctx.is_dtensor(cache_k):
        out = _decode_sharded(q.reshape(b, hkv, g, dh), knew, vnew, cache_k, cache_v, pos)
        return _project_out(cfg, p, out).to(x.dtype), cache_k, cache_v
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


def _project_out(cfg, p, out):
    """out [B, Hkv, G, dh] -> [B, 1, D] through ``wo`` in the compute dtype."""
    cd = cfg.torch_compute_dtype()
    b, hkv, g, dh = out.shape
    return out.reshape(b, 1, hkv * g * dh).to(cd) @ p["wo"].to(cd)


def _decode_sharded(q, knew, vnew, cache_k, cache_v, pos):
    """One-token attention over a cache of DTensors placed by
    ``sharding.cache_sharding`` (the batch over the DP axes, the key heads
    over ``model`` where they divide, else the positions), per rank on its
    own shards: q [B, Hkv, G, dh] (and the new k/v [B, Hkv, 1, dh], written
    at the 0-dim ``pos`` where given) are placed like the cache but whole
    along the positions; each rank writes the new k/v where ``pos`` falls
    in its range and attends over its positions, and where the positions
    are split the softmax's max, sum and output are all-reduced over those
    mesh dims (flash decoding). Returns the output [B, Hkv, G, dh] (f32) as
    a DTensor placed like q."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate

    mesh = cache_k.device_mesh
    split = [i for i, pl in enumerate(cache_k.placements) if pl.is_shard(2)]
    qpl = [Replicate() if i in split else pl for i, pl in enumerate(cache_k.placements)]
    b, hkv, g, dh = q.shape
    ql = sh.placed_as(q, qpl).to_local()
    kl, vl = cache_k.to_local(), cache_v.to_local()
    lo, n = sh.local_range(cache_k, 2)
    pos_at = lo + torch.arange(n, device=kl.device)
    if knew is not None:
        at = pos.reshape(1).long() - lo
        inside = (at >= 0) & (at < n)
        idx = at.clamp(0, max(n - 1, 0))
        for cl, new in ((kl, knew), (vl, vnew)):
            new = sh.placed_as(new, qpl).to_local().to(cl.dtype)
            cl.index_copy_(2, idx, torch.where(inside, new, cl.index_select(2, idx)))

    def over_split(t, op):
        for i in split:
            t = funcol.all_reduce(t, op, (mesh, i))
            t = t.wait() if hasattr(t, "wait") else t
        return t

    logits = torch.einsum("bhgd,bhkd->bhgk", ql.float() * (dh ** -0.5), kl.float())
    if knew is not None:
        logits = logits.masked_fill(~(pos_at <= pos), NEG_INF)
    m = over_split(logits.amax(-1), "max")
    w = torch.exp(logits - m[..., None])
    den = over_split(w.sum(-1), "sum")
    num = over_split(torch.einsum("bhgk,bhkd->bhgd", w, vl.float()), "sum")
    out = num / den[..., None]
    return DTensor.from_local(out, mesh, qpl, run_check=False, shape=(b, hkv, g, dh),
                              stride=(hkv * g * dh, g * dh, dh, 1))


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
