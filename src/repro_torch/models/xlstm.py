"""xLSTM mixers (the port of ``repro.models.xlstm``): mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory, a sequential scan)
[arXiv:2405.04517].

mLSTM runs the log-domain-stabilised chunkwise algorithm: within a chunk of
R tokens the interaction is a masked (R x R) matrix; across chunks the f32
state (C [dh, dh], n [dh], m) is carried, so decode keeps O(1) state per
head. R follows the reference's rule: ``min(mlstm_chunk, S)``, halved until
it divides S, so an odd S runs one token per chunk. The loop over chunks
and the sLSTM's loop over tokens are Python loops, as ``transformer.py``
does for ``lax.scan``. Under autograd each mLSTM chunk's intra-chunk
matrices are recomputed in the backward (``layers.remat``, the reference's
``jax.checkpoint`` per chunk).

On DTensor inputs each mixer runs mapped over the data-parallel mesh axes
with its parameters whole (``pctx.map_rows``, a ``local_map``), in the form
the reference's own record shows for the installed context (its
``_shard_map_mixer`` runs under ``shard_map`` only where the launcher put
the mesh in the context, ``pctx.mesh()``, and else under XLA's
partitioner):

- the mLSTM's chunk loop carries no weight, so it is one region around the
  whole loop either way, its weights' gradients summed once at its end;
- the sLSTM's scan body carries the recurrent weights, and the reference
  sums their gradients over the DP axes at every time step, with a mesh
  too (``shard_map``'s transpose of a replicated weight used in a scan
  body is a psum in that body, one all-reduce of ``r``'s and ``b``'s
  gradients together). So each time step is a region of its own
  (``_slstm_steps``), ``r`` and ``b`` whole, and ``pctx.sum_each_use``
  sums their gradients in one all-reduce per step. Without a mesh the
  partitioner also keeps ``r`` on its ``model`` shards (its columns, as the
  parameter is placed): each step's recurrent product is then a column
  product over ``model`` whose output is gathered, and whose gradient to
  the state is summed over ``model`` at every step.

Decode is one step either way (``_decode_rows``). On plain tensors every
form is the same plain call. Neither mixer has a kernel in the reference:
both are plain torch here, as the mamba scan is.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.parallel import context as pctx

_EPS = 1e-6
_M_FLOOR = -1e30  # the stabiliser's start, and its guard against all -inf rows


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def m_dims(cfg) -> Tuple[int, int]:
    """(inner width, head dim) of the mLSTM: twice d_model over n_heads."""
    di = 2 * cfg.d_model
    return di, di // cfg.n_heads


def init_mlstm(cfg, gen, lead: Tuple[int, ...] = ()) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    di, _ = m_dims(cfg)
    dt = cfg.torch_param_dtype()
    dev = gen.device
    sc = d ** -0.5
    return {
        "wq": L.normal(gen, lead + (d, di), sc, dt),
        "wk": L.normal(gen, lead + (d, di), sc, dt),
        "wv": L.normal(gen, lead + (d, di), sc, dt),
        "w_i": L.normal(gen, lead + (d, h), sc, dt),
        "w_f": L.normal(gen, lead + (d, h), sc, dt),
        "f_bias": torch.full(lead + (h,), 3.0, dtype=dt, device=dev),  # open forget gates
        "w_o": L.normal(gen, lead + (d, di), sc, dt),
        "scale": torch.ones(lead + (di,), dtype=dt, device=dev),
        "out_proj": L.normal(gen, lead + (di, d), di ** -0.5, dt),
    }


def _mlstm_qkv_gates(cfg, p, x):
    """x [B, S, D] -> q, k, v [B, H, S, dh] f32 (q scaled by dh^-0.5), the
    log input and forget gates li, lf [B, H, S] f32 and the output gate o
    [B, S, di] in the compute dtype."""
    cd = cfg.torch_compute_dtype()
    b, s, _ = x.shape
    h = cfg.n_heads
    _, dh = m_dims(cfg)
    xc, x32 = x.to(cd), x.float()
    q, k, v = ((xc @ p[w].to(cd)).reshape(b, s, h, dh).transpose(1, 2)
               for w in ("wq", "wk", "wv"))
    li = (x32 @ p["w_i"].float()).transpose(1, 2)
    lf = F.logsigmoid(x32 @ p["w_f"].float() + p["f_bias"].float()).transpose(1, 2)
    o = torch.sigmoid(xc @ p["w_o"].to(cd))
    return q.float() * (dh ** -0.5), k.float(), v.float(), li, lf, o


def _mlstm_chunk(q, k, v, li, lf, carry):
    """One chunk. q, k, v [B, H, R, dh]; li, lf [B, H, R]; carry (C, n, m)
    -> (h [B, H, R, dh], the carry after the chunk)."""
    c0, n0, m0 = carry
    r = q.shape[2]
    bcum = torch.cumsum(lf, dim=2)  # [B, H, R] inclusive
    # pairwise log weights w[t, s] = b_t - b_s + li_s (s <= t)
    logw = bcum[..., :, None] - bcum[..., None, :] + li[..., None, :]
    above = torch.ones((r, r), dtype=torch.bool, device=q.device).triu(1)
    logw = logw.masked_fill(above, float("-inf"))
    s_inter = m0[..., None] + bcum  # [B, H, R]
    m_t = torch.maximum(logw.amax(-1), s_inter).clamp_min(_M_FLOOR)

    w_intra = (q @ k.transpose(-1, -2)) * torch.exp(logw - m_t[..., None])
    inter_scale = torch.exp(s_inter - m_t)  # [B, H, R]
    num = w_intra @ v + inter_scale[..., None] * (q @ c0)
    den = w_intra.sum(-1) + inter_scale * (q @ n0[..., None])[..., 0]
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    b_r = bcum[..., -1]  # [B, H]
    wcar = b_r[..., None] - bcum + li  # [B, H, R]
    m_new = torch.maximum(m0 + b_r, wcar.amax(-1))
    cscale = torch.exp(m0 + b_r - m_new)
    kw = torch.exp(wcar - m_new[..., None])[..., None] * k  # [B, H, R, dh]
    c1 = cscale[..., None, None] * c0 + kw.transpose(-1, -2) @ v
    n1 = cscale[..., None] * n0 + kw.sum(2)
    return h, (c1, n1, m_new)


def _mlstm_out(cfg, p, hseq, o, x):
    """hseq [B, H, S, dh] f32 -> the block output [B, S, D] in x's dtype."""
    cd = cfg.torch_compute_dtype()
    b, _, s, _ = hseq.shape
    di, _ = m_dims(cfg)
    y = hseq.transpose(1, 2).reshape(b, s, di).to(cd) * p["scale"].to(cd) * o
    return (y @ p["out_proj"].to(cd)).to(x.dtype)


def _mlstm_core(cfg, p: Dict, x: torch.Tensor, init_state: Dict):
    s = x.shape[1]
    q, k, v, li, lf, o = _mlstm_qkv_gates(cfg, p, x)
    r = min(cfg.mlstm_chunk, s)
    while s % r:
        r //= 2
    carry = (init_state["C"], init_state["n"], init_state["m"])
    hs = []
    for c0 in range(0, s, r):
        part = slice(c0, c0 + r)
        h, carry = L.remat(_mlstm_chunk, q[:, :, part], k[:, :, part],
                           v[:, :, part], li[..., part], lf[..., part], carry)
        hs.append(h)
    c1, n1, m1 = carry
    return _mlstm_out(cfg, p, torch.cat(hs, dim=2), o, x), {"C": c1, "n": n1, "m": m1}


def _shard_map_mixer(core, init_cache, state_keys, cfg, p: Dict, x: torch.Tensor):
    """``core(cfg, p, x, init_state)`` on each rank's batch rows with the
    mixer's parameters whole (``pctx.map_rows``: their gradients summed
    over the DP axes at the boundary, not per time step), the initial state
    drawn for the local rows; a plain call on plain tensors. Returns (out,
    the final state of ``state_keys``)."""
    keys = sorted(p)

    def local(x, *w):
        out, state = core(cfg, dict(zip(keys, w)), x,
                          init_cache(cfg, x.shape[0], x.device))
        return (out,) + tuple(state[n] for n in state_keys)

    outs = pctx.map_rows(local, (x,) + tuple(p[k] for k in keys),
                         (True,) + (False,) * len(keys), n_out=1 + len(state_keys))
    return outs[0], dict(zip(state_keys, outs[1:]))


def mlstm_forward(cfg, p: Dict, x: torch.Tensor, return_state: bool = False):
    """Prefill path. x [B, S, D] -> [B, S, D] (+ the final decode cache
    ``{C, n, m}`` when ``return_state``)."""
    out, state = _shard_map_mixer(_mlstm_core, init_mlstm_cache, ("C", "n", "m"), cfg,
                                  p, x)
    if return_state:
        return out, state
    return out


def init_mlstm_cache(cfg, batch: int, device, lead: Tuple[int, ...] = ()) -> Dict:
    """f32 ``{C [B, H, dh, dh], n [B, H, dh], m [B, H]}`` (after ``lead``);
    m starts at the stabiliser's floor."""
    h = cfg.n_heads
    _, dh = m_dims(cfg)
    zeros = lambda *shape: torch.zeros(lead + (batch, h) + shape, device=device)
    return {"C": zeros(dh, dh), "n": zeros(dh),
            "m": torch.full(lead + (batch, h), _M_FLOOR, device=device)}


def _decode_rows(step, state_keys, cfg, p: Dict, x: torch.Tensor, cache: Dict):
    """``step(cfg, p, x, state)`` on each rank's batch rows, with the
    mixer's parameters whole and the state's rows (``pctx.map_rows``), as
    the prefill runs (``_shard_map_mixer``); a plain call on plain tensors.
    Returns (y, the new state of ``state_keys``)."""
    keys = sorted(p)

    def local(x, *a):
        y, state = step(cfg, dict(zip(keys, a)), x, dict(zip(state_keys, a[len(keys):])))
        return (y,) + tuple(state[n] for n in state_keys)

    args = (x,) + tuple(p[k] for k in keys) + tuple(cache[n] for n in state_keys)
    rows = (True,) + (False,) * len(keys) + (True,) * len(state_keys)
    outs = pctx.map_rows(local, args, rows, n_out=1 + len(state_keys))
    return outs[0], dict(zip(state_keys, outs[1:]))


def mlstm_decode(cfg, p: Dict, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token, x [B, 1, D]: the recurrent form (a chunk of one) ->
    (y [B, 1, D], the new ``{C, n, m}``), on each rank's rows
    (``_decode_rows``)."""
    return _decode_rows(_mlstm_step, ("C", "n", "m"), cfg, p, x, cache)


def _mlstm_step(cfg, p: Dict, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    q, k, v, li, lf, o = _mlstm_qkv_gates(cfg, p, x)
    h, (c1, n1, m1) = _mlstm_chunk(q, k, v, li, lf, (cache["C"], cache["n"], cache["m"]))
    return _mlstm_out(cfg, p, h, o, x), {"C": c1, "n": n1, "m": m1}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(cfg, gen, lead: Tuple[int, ...] = ()) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dt = cfg.torch_param_dtype()
    bias = torch.zeros(4 * d, dtype=dt, device=gen.device)
    bias[2 * d:3 * d] = 3.0  # the forget gate's preactivation
    return {
        "w_in": L.normal(gen, lead + (d, 4 * d), d ** -0.5, dt),  # z, i, f, o
        "r": L.normal(gen, lead + (h, dh, 4 * dh), dh ** -0.5, dt),  # block-diagonal
        "b": bias.expand(lead + (4 * d,)).contiguous(),
        "out_proj": L.normal(gen, lead + (d, d), d ** -0.5, dt),
    }


def _slstm_rec(cfg, r, h):
    """The recurrent preactivation h [B, D] @ the block-diagonal r [H, dh,
    4dh] -> [B, H, 4dh] f32 (``r`` may be a shard of its columns)."""
    b, d = h.shape
    nh = cfg.n_heads
    return (h.reshape(b, nh, 1, d // nh).float() @ r.float())[:, :, 0]


def _slstm_step(cfg, p, state, xw):
    """state (c, n, h, m), each [B, D] f32; xw [B, 4D] the input
    preactivation -> (the new state, h)."""
    rec = _slstm_rec(cfg, p["r"], state[2])
    return _slstm_gates(state, xw, rec.reshape(rec.shape[0], -1), p["b"])


def _slstm_gates(state, xw, rec, bias):
    """The step after the recurrent product: rec [B, 4D] f32."""
    c, n, _, m = state
    pre = xw.float() + rec + bias.float()
    zt, it, ft, ot = pre.chunk(4, dim=-1)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(zt)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(ot) * c_new / n_new.clamp_min(_EPS)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_core(cfg, p: Dict, x: torch.Tensor, init_state: Dict):
    cd = cfg.torch_compute_dtype()
    xw = x.to(cd) @ p["w_in"].to(cd)  # [B, S, 4D]
    # the f32 recurrent weights and bias, cast once and not at every token
    pf = {"r": p["r"].float(), "b": p["b"].float()}
    state = tuple(init_state[key] for key in ("c", "n", "h", "m"))
    hs = []
    for t in range(x.shape[1]):
        state, h = _slstm_step(cfg, pf, state, xw[:, t])
        hs.append(h)
    y = torch.stack(hs, dim=1).to(cd)  # [B, S, D]
    out = (y @ p["out_proj"].to(cd)).to(x.dtype)
    return out, dict(zip(("c", "n", "h", "m"), state))


def _slstm_steps(cfg, p: Dict, x: torch.Tensor):
    """``_slstm_core`` on DTensors, one region per time step (the module
    docstring): the input and output products are regions over the whole
    sequence, and each step sums ``r``'s and ``b``'s gradients over the DP
    axes (``pctx.sum_each_use``). With the context's mesh (``shard_map``)
    ``r`` goes in whole; without it the step's recurrent product runs on
    ``r``'s ``model`` shards (``pctx.region``, split) and its output is
    gathered."""
    cd = cfg.torch_compute_dtype()
    s = x.shape[1]
    keys = ("c", "n", "h", "m")
    mapped = pctx.mesh() is not None
    xw = pctx.map_rows(lambda x, w: x.to(cd) @ w.to(cd), (x, p["w_in"]), (True, False))
    xws = pctx.map_rows(lambda xw: xw[:, 0] if s == 1 else xw.unbind(1), (xw,), (True,),
                        n_out=s)
    xws = (xws,) if s == 1 else xws
    state = pctx.map_rows(
        lambda x: tuple(init_slstm_cache(cfg, x.shape[0], x.device)[k] for k in keys),
        (x,), (True,), n_out=len(keys))
    # gathered once: each step takes them as they are
    r, bias = (pctx.whole(p["r"]) if mapped else p["r"]), pctx.whole(p["b"])

    def step(c, n, h, m, xw_t, r, bias):
        return _slstm_step(cfg, {"r": r, "b": bias}, (c, n, h, m), xw_t)[0]

    def gates(c, n, m, xw_t, rec, bias):
        return _slstm_gates((c, n, None, m), xw_t, rec, bias)[0]

    hs = []
    for t in range(s):
        r_t, b_t = pctx.sum_each_use(r, bias)
        if mapped:
            state = pctx.map_rows(step, (*state, xws[t], r_t, b_t), (True,) * 5 + (False,) * 2,
                                  n_out=len(keys))
        else:
            rec = pctx.region(lambda h, r: _slstm_rec(cfg, r, h), [state[2]], [(r_t, 2)],
                              outs=(2,))
            rec = pctx.batch_only(rec)
            rec = rec.reshape(rec.shape[0], -1)
            c, n, _, m = state
            state = pctx.map_rows(gates, (c, n, m, xws[t], rec, b_t), (True,) * 5 + (False,),
                                  n_out=len(keys))
        hs.append(state[2])
    y = torch.stack(hs, dim=1)  # [B, S, D]
    out = pctx.map_rows(lambda y, w: (y.to(cd) @ w.to(cd)).to(x.dtype),
                        (y, p["out_proj"]), (True, False))
    return out, dict(zip(keys, state))


def slstm_forward(cfg, p: Dict, x: torch.Tensor, return_state: bool = False):
    """Prefill path. x [B, S, D] -> [B, S, D] (+ the final decode cache
    ``{c, n, h, m}`` when ``return_state``); on DTensors one region per
    time step (``_slstm_steps``)."""
    if pctx.is_dtensor(x):
        out, state = _slstm_steps(cfg, p, x)
    else:
        out, state = _slstm_core(cfg, p, x, init_slstm_cache(cfg, x.shape[0], x.device))
    if return_state:
        return out, state
    return out


def init_slstm_cache(cfg, batch: int, device, lead: Tuple[int, ...] = ()) -> Dict:
    """f32 ``{c, n, h, m}``, each [B, D] (after ``lead``); m starts at the
    stabiliser's floor."""
    shape = lead + (batch, cfg.d_model)
    z = lambda: torch.zeros(shape, device=device)
    return {"c": z(), "n": z(), "h": z(), "m": torch.full(shape, _M_FLOOR, device=device)}


def slstm_decode(cfg, p: Dict, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token, x [B, 1, D] -> (y [B, 1, D], the new ``{c, n, h, m}``), on
    each rank's rows (``_decode_rows``): the head view of the state
    (``_slstm_step``) then sees whole rows, never a shard of them."""
    return _decode_rows(_slstm_decode_step, ("c", "n", "h", "m"), cfg, p, x, cache)


def _slstm_decode_step(cfg, p: Dict, x: torch.Tensor, cache: Dict):
    cd = cfg.torch_compute_dtype()
    xw = x[:, 0].to(cd) @ p["w_in"].to(cd)
    state = tuple(cache[key] for key in ("c", "n", "h", "m"))
    state, h = _slstm_step(cfg, p, state, xw)
    y = (h.to(cd) @ p["out_proj"].to(cd)).to(x.dtype)
    return y[:, None], dict(zip(("c", "n", "h", "m"), state))
