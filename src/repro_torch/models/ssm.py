"""Mamba (S6) selective-SSM mixer (the port of ``repro.models.ssm``).

Prefill runs a chunked scan: a Python loop over sequence chunks carrying the
f32 state, and inside each chunk a doubling (Hillis-Steele) scan, log2(chunk)
elementwise passes, so the discretised [B, chunk, d_inner, N] tensors stay
bounded. Decode carries (conv_state [B, K-1, d_inner], ssm_state
[B, d_inner, N]).

The reference halves the chunk until it divides S, so an odd S scans one
token at a time; the port keeps the chunk and lets the last one be ragged,
which computes the same function. Under autograd each chunk's discretised
tensors are recomputed in the backward (``layers.remat``, the reference's
``jax.checkpoint`` per chunk).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.parallel import context as pctx


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def init_mamba(cfg, gen, lead: Tuple[int, ...] = ()) -> Dict:
    d, di, n = cfg.d_model, d_inner(cfg), cfg.ssm_state
    k = cfg.ssm_conv
    dt_rank = max(1, d // 16)
    dt = cfg.torch_param_dtype()
    dev = gen.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))
    return {
        "in_proj": L.normal(gen, lead + (d, 2 * di), d ** -0.5, dt),
        "conv_w": L.normal(gen, lead + (k, di), k ** -0.5, dt),
        "conv_b": torch.zeros(lead + (di,), dtype=dt, device=dev),
        "w_bc": L.normal(gen, lead + (di, 2 * n), di ** -0.5, dt),
        "w_dt": L.normal(gen, lead + (di, dt_rank), di ** -0.5, dt),
        "dt_proj": L.normal(gen, lead + (dt_rank, di), dt_rank ** -0.5, dt),
        "dt_bias": torch.full(lead + (di,), -4.6, dtype=dt, device=dev),  # softplus^-1(0.01)
        "A_log": a_log.expand(lead + (di, n)).to(dt).contiguous(),
        "D": torch.ones(lead + (di,), dtype=dt, device=dev),
        "out_proj": L.normal(gen, lead + (di, d), di ** -0.5, dt),
    }


def _discretise(p, x):
    """x [..., di] -> (dA [..., di, N], dBx [..., di, N], C [..., N]) in f32."""
    xf = x.float()
    bc = xf @ p["w_bc"].float()  # [..., 2N]
    n = bc.shape[-1] // 2
    b_t, c_t = bc[..., :n], bc[..., n:]
    dt = F.softplus(
        (xf @ p["w_dt"].float()) @ p["dt_proj"].float() + p["dt_bias"].float()
    )  # [..., di]
    a = -torch.exp(p["A_log"].float())  # [di, N]
    dA = torch.exp(dt[..., None] * a)  # [..., di, N]
    dBx = (dt * xf)[..., None] * b_t[..., None, :]  # [..., di, N]
    return dA, dBx, c_t


def _chunk_scan(carry_h, dA, dBx):
    """Inclusive scan of h_t = dA_t * h_{t-1} + dBx_t within a chunk by
    doubling: after the pass at offset o every position holds the combined
    (dA, dBx) of the up to 2o positions ending at it. dA/dBx [B, C, di, N];
    h0 [B, di, N] -> (h [B, C, di, N], h at the last position)."""
    a, bx = dA, dBx
    c = a.shape[1]
    off = 1
    while off < c:
        bx = torch.cat([bx[:, :off], bx[:, :-off] * a[:, off:] + bx[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    h = a * carry_h[:, None] + bx
    return h, h[:, -1]


# the mixer's weights that the scan reads, past the input projection
_SCAN_KEYS = ("A_log", "D", "conv_b", "conv_w", "dt_bias", "dt_proj", "w_bc", "w_dt")


def _conv_scan(cfg, p: Dict, xz: torch.Tensor, chunk: int):
    """xz [B, S, 2di] (the input projection) -> (y [B, S, di] in the
    compute dtype, gated, before the output projection; the conv state
    [B, K-1, di]; h [B, di, N]): the causal depthwise conv, the selective
    scan and the gate."""
    b, s, _ = xz.shape
    di = d_inner(cfg)
    cd = cfg.torch_compute_dtype()
    k = cfg.ssm_conv
    xi, z = xz[..., :di], xz[..., di:]
    # causal depthwise conv (width k)
    xp = torch.cat([xi.new_zeros((b, k - 1, di)), xi], dim=1)
    w = p["conv_w"].to(cd)
    conv = sum(xp[:, i:i + s, :] * w[i] for i in range(k)) + p["conv_b"].to(cd)
    u = F.silu(conv)  # [B, S, di]

    c = min(chunk, s)
    h = torch.zeros((b, di, cfg.ssm_state), dtype=torch.float32, device=xz.device)

    def scan_chunk(h, u_i):
        dA, dBx, c_t = _discretise(p, u_i)  # [B, c, di, N]
        hs, h = _chunk_scan(h, dA, dBx)
        return h, torch.einsum("bcdn,bcn->bcd", hs, c_t)  # [B, c, di]

    ys = []
    for c0 in range(0, s, c):
        h, y = L.remat(scan_chunk, h, u[:, c0:c0 + c])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + u.float() * p["D"].float()
    return y.to(cd) * F.silu(z), xp[:, s:s + k - 1], h


def mamba_forward(cfg, p: Dict, x: torch.Tensor, chunk: int = 0,
                  return_state: bool = False):
    """Prefill path. x [B, S, D] -> [B, S, D] (+ the final decode cache
    ``{conv, h}`` when ``return_state``). On a mesh the projections run on
    DTensors and the conv and scan on each rank's batch rows, with the
    scan's weights whole (``pctx.map_rows``)."""
    chunk = chunk or cfg.ssm_chunk
    cd = cfg.torch_compute_dtype()
    xz = x.to(cd) @ p["in_proj"].to(cd)  # [B, S, 2di]
    y, conv_state, h = pctx.map_rows(
        lambda xz, *w: _conv_scan(cfg, dict(zip(_SCAN_KEYS, w)), xz, chunk),
        (xz,) + tuple(p[key] for key in _SCAN_KEYS),
        (True,) + (False,) * len(_SCAN_KEYS), n_out=3)
    out = (y @ p["out_proj"].to(cd)).to(x.dtype)
    if return_state:
        return out, {"conv": conv_state, "h": h}
    return out


def init_mamba_cache(cfg, batch: int, dtype, device, lead: Tuple[int, ...] = ()) -> Dict:
    di = d_inner(cfg)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros(lead + (batch, di, cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }


def mamba_decode(cfg, p: Dict, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token. x [B, 1, D] -> (y [B, 1, D], new cache)."""
    di = d_inner(cfg)
    cd = cfg.torch_compute_dtype()

    xz = x[:, 0].to(cd) @ p["in_proj"].to(cd)
    xi, z = xz[..., :di], xz[..., di:]
    window = torch.cat([cache["conv"], xi[:, None]], dim=1)  # [B, k, di]
    conv = (torch.einsum("bkd,kd->bd", window.to(cd), p["conv_w"].to(cd))
            + p["conv_b"].to(cd))
    u = F.silu(conv)  # [B, di]
    dA, dBx, c_t = _discretise(p, u)  # [B, di, N], [B, N]
    h = cache["h"] * dA + dBx
    y = torch.einsum("bdn,bn->bd", h, c_t)
    y = y + u.float() * p["D"].float()
    y = y.to(cd) * F.silu(z)
    out = (y @ p["out_proj"].to(cd)).to(x.dtype)
    return out[:, None], {"conv": window[:, 1:], "h": h}
