"""Shared layers (plain functions over dicts of tensors).

Parameters of a layer stack carry a leading group dimension ``lead`` (see
``models/transformer.py``); the functions here take one group's slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.parallel import context as pctx
from repro_torch.spans import span


def _needs_grad(args) -> bool:
    return any(_needs_grad(a) if isinstance(a, (tuple, list))
               else torch.is_tensor(a) and a.requires_grad for a in args)


def _keep_collectives(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat``: a collective's result
    (``torch.ops._c10d_functional``, and the dry run's ``_dtensor``
    all-to-all) is saved, every other op recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    if getattr(op, "namespace", None) in ("_c10d_functional", "_dtensor"):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, *args):
    """``fn(*args)``; under autograd, when a tensor among ``args`` needs a
    gradient, with its activations dropped and recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``); on a
    mesh of more than one rank the results of its collectives are kept, so
    the recompute issues none of the forward's again. The serving path,
    where nothing needs a gradient, calls ``fn`` directly."""
    if not (torch.is_grad_enabled() and _needs_grad(args)):
        return fn(*args)
    if not any(pctx.is_dtensor(a) and a.device_mesh.size() > 1 for a in args):
        # no collective to keep: no dispatch mode over every op
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: create_selective_checkpoint_contexts(_keep_collectives))


# A leaf of more elements than this is drawn one slice of its first axis at a
# time, so that its f32 scratch stays at most 8 GiB (a full-width MoE stack's
# expert weights are 6.4 B elements per leaf).
DRAW_CHUNK = 2**31


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 on the generator's device, then cast.
    On the meta device (``launch/specs.abstract_params``) nothing is drawn:
    the result has the shape and dtype only."""
    shape = tuple(shape)
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if len(shape) > 1 and math.prod(shape) > DRAW_CHUNK:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        for i in range(shape[0]):
            out[i] = normal(gen, shape[1:], scale, dtype)
        return out
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return x.normal_(generator=gen).mul_(scale).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def init_norm(cfg, device, lead: Tuple[int, ...] = ()) -> Dict:
    """RMSNorm keeps a scale ``w`` (ones); layernorm a scale ``w`` (ones)
    and a shift ``b`` (zeros)."""
    shape, dt = lead + (cfg.d_model,), cfg.torch_param_dtype()
    p = {"w": torch.ones(shape, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(shape, dtype=dt, device=device)
    elif cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return p


def apply_norm(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Layernorm where ``p`` has a shift ``b``, else RMSNorm; statistics in
    f32, the result cast back to ``x``'s dtype."""
    xf = x.float()
    if "b" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).pow(2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * p["w"].float() + p["b"].float()).to(x.dtype)
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + cfg.norm_eps)
    return (y * p["w"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def rope_tables(cfg, positions: torch.Tensor, d: Optional[int] = None):
    """positions [.., S] -> (sin, cos) each [..., S, d/2] in f32."""
    d = d or cfg.head_dim
    half = d // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = cfg.rope_theta ** (-idx / half)
    ang = positions.float()[..., None] * freqs  # [..., S, half]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [..., S, D]; rotate-half convention."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


ACTIVATIONS = ("swiglu", "geglu", "sq_relu", "gelu")


def init_dense_mlp(cfg, gen, lead: Tuple[int, ...] = (),
                   d_ff: Optional[int] = None) -> Dict:
    """A dense MLP of width ``d_ff`` (default ``cfg.d_ff``; an MoE's shared
    expert passes ``d_expert``): ``w1``/``w2``, and the gate ``w3`` for the
    gated activations (SwiGLU, GeGLU) only."""
    if cfg.activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {cfg.activation!r}")
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.torch_param_dtype()
    p = {
        "w1": normal(gen, lead + (d, f), d ** -0.5, dt),
        "w2": normal(gen, lead + (f, d), f ** -0.5, dt),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["w3"] = normal(gen, lead + (d, f), d ** -0.5, dt)
    return p


def _act(cfg, h: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
    """The MLP's activation; GELU is the tanh form (``jax.nn.gelu``'s
    default)."""
    if cfg.activation == "swiglu":
        return F.silu(h) * g
    if cfg.activation == "geglu":
        return F.gelu(h, approximate="tanh") * g
    if cfg.activation == "sq_relu":
        r = F.relu(h)
        return r * r
    if cfg.activation == "gelu":
        return F.gelu(h, approximate="tanh")
    raise ValueError(f"unknown activation {cfg.activation!r}")


def apply_dense_mlp(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The MLP of [B, S, D] ``x``. On a mesh, one ``pctx.region`` in the
    layout ``pctx.layout_of`` picks for its weights and ``x``'s shards:
    token-gathered, ``w1``/``w3`` split over ``model`` by columns and
    ``w2`` by rows where ``d_ff`` divides it; or weight-gathered. The
    output is placed like ``x``."""
    cd = cfg.torch_compute_dtype()
    names = ("w1", "w2", "w3") if "w3" in p else ("w1", "w2")

    def mlp(x, w1, w2, w3=None):
        xc = x.to(cd)
        h = xc @ w1.to(cd)
        g = xc @ w3.to(cd) if w3 is not None else None
        return (_act(cfg, h, g) @ w2.to(cd)).to(x.dtype)

    weights = [(p[k], 0 if k == "w2" else 1) for k in names]
    if not pctx.is_dtensor(x):
        return mlp(x, *(w for w, _ in weights))
    layout = pctx.layout_of([tuple(p[k].shape) for k in names], x)
    split = p["w1"].shape[1] % pctx.tp_size(x.device_mesh) == 0
    return pctx.region(mlp, (x,), weights, layout=layout, split=split)


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------


def init_embed(cfg, gen) -> Dict:
    dt = cfg.torch_param_dtype()
    p = {"tok": normal(gen, (cfg.vocab, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["head"] = normal(gen, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5, dt)
    return p


def embed(cfg, p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings; on a mesh, each rank gathers its batch rows
    from the whole table (``pctx.map_rows``), the table's gradient summed
    over the DP axes: DTensor's strategy for the backward's ``index_put``
    fails on torch 2.11 with the rows sharded."""
    rows = pctx.map_rows(lambda tok, ids: tok[ids.long()], (p["tok"], tokens), (False, True))
    return rows.to(cfg.torch_compute_dtype())


def unembed(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.torch_compute_dtype()
    w = p["head"] if "head" in p else p["tok"].T
    return x.to(cd) @ w.to(cd)


def cross_entropy_loss(cfg, p: Dict, x: torch.Tensor, labels: torch.Tensor,
                       seq_chunk: int = 1024) -> torch.Tensor:
    """Mean softmax cross-entropy of the unembedded ``x`` [B, S, D] against
    ``labels`` [B, S], over sequence chunks of ``seq_chunk`` (halved until
    it divides S); each chunk's logits [B, c, V] are recomputed in the
    backward, so no [B, S, V] tensor lives (the reference's chunked scan).

    Vocab-parallel: one ``pctx.region`` (a plain call on a plain tensor;
    on a mesh token-gathered, the tokens gathered over their sequence
    shards and the unembedding over its FSDP shards once) gives each rank,
    per position, the logsumexp of its vocab shard's logits and the gold
    logit where the shard holds the label (0 elsewhere). On a mesh these
    [B, S] pairs are gathered over ``model``; the loss is the logsumexp of
    the ranks' logsumexps less the sum of their gold logits (of one shard,
    its own pair). No [B, c, V] tensor leaves its rank."""
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel.sharding import placed_as

    b, s, _ = x.shape
    c = min(seq_chunk, s)
    while s % c:
        c //= 2
    w = p["head"] if "head" in p else p["tok"].T
    tp = pctx.tp_size(x.device_mesh) if pctx.is_dtensor(x) else 1
    split = w.shape[1] % tp == 0
    # the first vocab entry of this rank's shard
    first = w.shape[1] // tp * x.device_mesh.get_local_rank("model") if split and tp > 1 else 0
    cd = cfg.torch_compute_dtype()

    def chunk_stats(xi, wl, yi):
        with span("cross_entropy"):  # the forward, and its recompute
            logits = (xi.to(cd) @ wl.to(cd)).float()  # [B, c, V / tp]
            at = yi - first
            held = (at >= 0) & (at < logits.shape[-1])
            gold = torch.gather(logits, -1, at.clamp(0, logits.shape[-1] - 1)[..., None])
            return torch.stack([torch.logsumexp(logits, dim=-1),
                                torch.where(held, gold[..., 0], 0.0)], dim=-1)

    def shard_stats(xl, yl, wl):
        yl = yl.long()
        return torch.cat([remat(chunk_stats, xl[:, c0:c0 + c], wl, yl[:, c0:c0 + c])
                          for c0 in range(0, s, c)], dim=1)  # [B, S, 2]

    stats = pctx.region(shard_stats, (x, labels.to(x.device)), [(w, 1)],
                        split=split, outs=(2,))
    if pctx.is_dtensor(stats):
        stats = placed_as(stats, [Replicate() if q.is_shard(2) else q
                                  for q in stats.placements])
    per = stats.reshape(b, s, -1, 2)  # [B, S, ranks, (logsumexp, gold)]
    lse, gold = torch.logsumexp(per[..., 0], dim=-1), per[..., 1].sum(-1)
    total = None
    for c0 in range(0, s, c):
        part = torch.sum(lse[:, c0:c0 + c] - gold[:, c0:c0 + c])
        total = part if total is None else total + part
    return total / (b * s)
