"""The plain reference of the served decoders: float32 PyTorch, TF32 off.

It imports nothing of the program. It reads the configuration file's keys
and the benchmark's weights (in the parameter layout the benchmark made
them in: one dict per position of the layer pattern, each leaf stacked over
the groups of layers) and runs each sequence whole, layer by layer, with no
cache and no batching. The equations are the model the port serves:

- RMSNorm, rotary embeddings (rotate-half) on every attention layer, GQA
  causal softmax attention, a SwiGLU MLP, an untied unembedding;
- Mamba: a causal depthwise conv, SiLU, dt = softplus(u W_dt P_dt + b),
  h_t = exp(dt A) h_{t-1} + dt u B_t, y = h C + D u, gated by SiLU(z),
  scanned one position at a time;
- MoE: softmax router over f32 logits, the top k by a stable sort
  (ties to the lower expert), gates renormalised over the k; each prompt
  is one row whose experts hold int(S k f / E) slots (Switch: an
  assignment ranked past them is dropped, and where a drop follows the
  row's first assignment to expert 0, that assignment is emptied), and
  each decoded token is a row of its own.

Where these depart from the published models (Jamba has no positional
encoding, norms inside its mamba, no capacity and no renormalisation of
its gates), the reference follows the port: it judges the program's
arithmetic, not its choice of model.

``precision="fp8"`` is the control: every product with a weight takes
both operands rounded to float8 e4m3 (per token and per output column
scales), the step below the configuration's bf16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    """Products with weights in the reference's precision."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w


def period(c: Dict) -> int:
    p = c.get("attn_layer_period") or 1
    if c.get("num_experts"):
        p = math.lcm(p, c.get("expert_layer_period", 1))
    return p


def head_dim(c: Dict) -> int:
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [H, L, D] at positions 0..L-1, rotate-half."""
    d = x.shape[-1]
    half = d // 2
    idx = torch.arange(half, dtype=torch.float32, device=x.device)
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] \
        * theta ** (-idx / half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(c: Dict, p: Dict, h: torch.Tensor, ops: Ops) -> torch.Tensor:
    n, d = h.shape
    hq, hkv, dh = c["num_attention_heads"], c["num_key_value_heads"], head_dim(c)
    g = hq // hkv
    theta = c.get("rope_theta", 10000.0)
    q = rope(ops.lin(h, p["wq"]).view(n, hq, dh).transpose(0, 1), theta)
    k = rope(ops.lin(h, p["wk"]).view(n, hkv, dh).transpose(0, 1), theta)
    v = ops.lin(h, p["wv"]).view(n, hkv, dh).transpose(0, 1)
    mask = torch.ones(n, n, dtype=torch.bool, device=h.device).tril()
    out = torch.empty(hq, n, dh, device=h.device)
    for j in range(hkv):
        s = q[j * g:(j + 1) * g] @ k[j].T * dh ** -0.5         # [g, n, n]
        s = s.masked_fill(~mask, float("-inf"))
        out[j * g:(j + 1) * g] = torch.softmax(s, dim=-1) @ v[j]
    return ops.lin(out.transpose(0, 1).reshape(n, hq * dh), p["wo"])


def mamba(c: Dict, p: Dict, h: torch.Tensor, ops: Ops) -> torch.Tensor:
    n, d = h.shape
    di = c["mamba_expand"] * d
    ns = c["mamba_d_state"]
    k = c["mamba_d_conv"]
    xz = ops.lin(h, p["in_proj"])
    x, z = xz[:, :di], xz[:, di:]
    xp = torch.cat([x.new_zeros(k - 1, di), x])
    w = p["conv_w"].float()
    u = F.silu(sum(xp[i:i + n] * w[i] for i in range(k)) + p["conv_b"].float())
    bc = ops.lin(u, p["w_bc"])
    b_t, c_t = bc[:, :ns], bc[:, ns:]
    dt = F.softplus(ops.lin(ops.lin(u, p["w_dt"]), p["dt_proj"]) + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())                           # [di, N]
    y = torch.empty(n, di, device=h.device)
    state = torch.zeros(di, ns, device=h.device)
    for t in range(n):
        state = torch.exp(dt[t, :, None] * a) * state + (dt[t] * u[t])[:, None] * b_t[t]
        y[t] = state @ c_t[t]
    y = (y + u * p["D"].float()) * F.silu(z)
    return ops.lin(y, p["out_proj"])


def mlp(p: Dict, h: torch.Tensor, ops: Ops) -> torch.Tensor:
    return ops.lin(F.silu(ops.lin(h, p["w1"])) * ops.lin(h, p["w3"]), p["w2"])


def route(c: Dict, p: Dict, h: torch.Tensor, ops: Ops) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts [n, k], gates [n, k]) of each token."""
    probs = torch.softmax(ops.lin(h, p["router"]), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = c["num_experts_per_tok"]
    gates, idx = srt.values[:, :k], srt.indices[:, :k]
    return idx, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)


def kept(c: Dict, idx: torch.Tensor) -> torch.Tensor:
    """Which of one row's assignments [s, k] hold a slot (Switch capacity,
    and the emptied assignment to expert 0)."""
    s, k = idx.shape
    e = c["num_experts"]
    cap = max(1, int(s * k * c.get("moe_capacity_factor", 1.25) / e))
    flat = idx.reshape(-1)
    rank = torch.zeros_like(flat)
    for ex in range(e):
        at = (flat == ex).nonzero()[:, 0]
        rank[at] = torch.arange(at.numel(), device=flat.device)
    keep = rank < cap
    zero = (flat == 0).nonzero()
    dropped = (~keep).nonzero()
    if zero.numel() and dropped.numel() and int(dropped.max()) > int(zero.min()):
        keep[int(zero.min())] = False
    return keep.view(s, k)


def moe(c: Dict, p: Dict, h: torch.Tensor, prompt_len: int, ops: Ops) -> torch.Tensor:
    idx, gates = route(c, p, h, ops)
    keep = torch.cat([kept(c, idx[:prompt_len])]
                     + [kept(c, idx[t:t + 1]) for t in range(prompt_len, h.shape[0])])
    w = gates * keep
    out = torch.zeros_like(h)
    for ex in range(c["num_experts"]):
        tok, slot = ((idx == ex) & keep).nonzero(as_tuple=True)
        if tok.numel():
            pe = {name: p[name][ex] for name in ("w1", "w2", "w3")}
            out.index_add_(0, tok, mlp(pe, h[tok], ops) * w[tok, slot, None])
    return out


def _layer(params: Dict, c: Dict, i: int) -> Dict:
    """Layer ``i``'s weights: pattern position i % period, group i // period."""
    per = period(c)
    stack = params["layers"][i % per]
    g = i // per

    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[g] for k, v in tree.items()}

    return pick(stack)


def _is_attention(c: Dict, i: int) -> bool:
    per = c.get("attn_layer_period")
    return per is None or i % per == c.get("attn_layer_offset", 0)


def _is_moe(c: Dict, i: int) -> bool:
    return bool(c.get("num_experts")) and \
        i % c.get("expert_layer_period", 1) == c.get("expert_layer_offset", 0)


def served_logits(c: Dict, params: Dict, sequences: Sequence[Tuple[List[int], List[int]]],
                  precision: str = "f32") -> List[torch.Tensor]:
    """For each (prompt, served tokens), the logits [n_out, V] at the
    positions that chose them: the prompt's last, then each served token's
    but the last. Each sequence runs once, whole."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = Ops(precision)
    eps = c["rms_norm_eps"]
    device = params["embed"]["tok"].device
    with torch.no_grad():
        xs = []
        for prompt, out in sequences:
            ids = torch.tensor(list(prompt) + list(out[:-1]), device=device)
            xs.append(params["embed"]["tok"][ids].float())
        for i in range(c["num_hidden_layers"]):
            p = _layer(params, c, i)
            for r, (prompt, _) in enumerate(sequences):
                x = xs[r]
                h = rms(x, p["norm1"]["w"], eps)
                mix = attention if _is_attention(c, i) else mamba
                x = x + mix(c, p["mixer"], h, ops)
                h = rms(x, p["norm2"]["w"], eps)
                if _is_moe(c, i):
                    x = x + moe(c, p["mlp"], h, len(prompt), ops)
                else:
                    x = x + mlp(p["mlp"], h, ops)
                xs[r] = x
        logits = []
        for (prompt, _), x in zip(sequences, xs):
            x = rms(x[len(prompt) - 1:], params["norm_f"]["w"], eps)
            logits.append(ops.lin(x, params["embed"]["head"]))
    return logits


def gaps(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """How far each chosen token's logit lies below the best one."""
    t = torch.as_tensor(list(tokens), device=logits.device)
    return logits.max(-1).values - logits.gather(1, t[:, None])[:, 0]
