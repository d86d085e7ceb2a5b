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


def remat(fn, *args):
    """``fn(*args)``; under autograd, when a tensor among ``args`` needs a
    gradient, with its activations dropped and recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``). The
    serving path, where nothing needs a gradient, calls ``fn`` directly."""
    if not (torch.is_grad_enabled() and _needs_grad(args)):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


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
    cd = cfg.torch_compute_dtype()
    xc = x.to(cd)
    h = xc @ p["w1"].to(cd)
    g = xc @ p["w3"].to(cd) if "w3" in p else None
    return (_act(cfg, h, g) @ p["w2"].to(cd)).to(x.dtype)


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
    backward, so no [B, S, V] tensor lives (the reference's chunked scan)."""
    b, s, _ = x.shape
    c = min(seq_chunk, s)
    while s % c:
        c //= 2
    x = pctx.whole_tokens(x)
    labels = labels.to(x.device).long()

    def chunk_loss(xi, yi):
        with span("cross_entropy"):  # the forward, and its recompute
            # vocab-sharded logits have no DTensor strategy for the gather
            logits = pctx.batch_only(unembed(cfg, p, xi).float())  # [B, c, V]
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, yi[..., None])[..., 0]
            return torch.sum(lse - gold)

    total = torch.zeros((), device=x.device)
    for c0 in range(0, s, c):
        total = total + remat(chunk_loss, x[:, c0:c0 + c], labels[:, c0:c0 + c])
    return total / (b * s)
