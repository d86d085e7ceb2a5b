"""Plain-torch oracles for the port's kernels (the counterpart of
``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Optional

import torch


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C = A @ B computed in f32, output in x's dtype."""
    return (x.float() @ y.float()).to(x.dtype)


def attention(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-softmax GQA attention oracle, computed in f32."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, s, d).float()
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)
