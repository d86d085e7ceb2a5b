"""Operations and bytes from shapes, the least time the card could take,
and model FLOPs.

``flash_work``, ``matmul_work`` and ``bound`` are frozen copies of the
functions of the same names in ``chip_smoke.py`` at commit a9c3ea2 (the
causal pairs counted, each input read once and each output written once);
``bound`` reads its peaks from ``peaks.json`` beside this file, the H100's
data sheet, and not from the program's ``hw/gpu_h100.py``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Tuple

from harness import config as C

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def flash_work(b, hq, hkv, s, d, causal, size: int = 2):
    """(flops, bytes) the attention forward must do/move with ``size``-byte
    elements (bf16: 2): q.k and p.v over the (causal) pairs, each input read
    once and the output written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * hq * d * pairs
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * size
    return flops, nbytes


def matmul_work(m, n, k, size: int = 2):
    """(flops, bytes) of C = A @ B with ``size``-byte elements (bf16: 2):
    each input read once, C written once."""
    return 2 * m * n * k, size * (m * k + k * n + m * n)


def bound(flops, nbytes, peak_flops=None) -> Tuple[float, str]:
    """(seconds, "operations" or "bytes"): the least time the card could
    take, the larger of the work at ``peak_flops`` (default bf16) and the
    bytes at the HBM rate."""
    peak_flops = peak_flops or PEAKS["bf16_flops"]
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAKS["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def token_flops(c: Dict, context: int) -> float:
    """Model FLOPs of one token at position ``context`` (attending over
    ``context + 1`` keys): two per weight it multiplies, the MoE's top-k
    experts only, and the attention scores and values (causal, so the
    keys before it and itself)."""
    flops = sum(2 * C.layer_matmul_params(c, i) for i in range(c["num_hidden_layers"]))
    flops += 4 * C.n_attention_layers(c) * c["num_attention_heads"] * C.head_dim(c) * (context + 1)
    return flops


def prefill_flops(c: Dict, s: int) -> float:
    """A prompt of ``s`` tokens, and the unembedding of its last position."""
    layers = sum(2 * C.layer_matmul_params(c, i) for i in range(c["num_hidden_layers"]))
    attn = 4 * C.n_attention_layers(c) * c["num_attention_heads"] * C.head_dim(c) * s * (s + 1) // 2
    return layers * s + attn + 2 * c["hidden_size"] * c["vocab_size"]


def decode_flops(c: Dict, positions: Iterable[int]) -> float:
    """One decode step of the live slots at ``positions`` (each token's
    index in its sequence), with their unembedding."""
    return sum(token_flops(c, p) + 2 * c["hidden_size"] * c["vocab_size"] for p in positions)


def train_flops(c: Dict, rows: int, seq: int) -> float:
    """Model FLOPs of one training step on ``rows`` x ``seq`` tokens: three
    times the forward (two per weight multiplied, the causal attention and
    the unembedding), no recomputation counted."""
    layers = sum(2 * C.layer_matmul_params(c, i) for i in range(c["num_hidden_layers"]))
    attn = 4 * C.n_attention_layers(c) * c["num_attention_heads"] * C.head_dim(c) \
        * seq * (seq + 1) // 2
    forward = rows * (seq * (layers + 2 * c["hidden_size"] * c["vocab_size"]) + attn)
    return 3 * forward
