"""A configuration file (published ``config.json`` keys, the cuts under
``reduced`` and the sizes set by hand under ``assumed``) and the port's
``ArchConfig`` that runs it.

Every key that shapes the computation is either mapped onto an
``ArchConfig`` field or checked against what the port computes; a key the
port cannot honour raises, so a file never runs as something it does not
say. The parameter counts used for model FLOPs come from the file's own
numbers, not from the program.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict

# file key -> ArchConfig field
FIELDS = {
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "num_hidden_layers": "n_layers",
    "vocab_size": "vocab",
    "rms_norm_eps": "norm_eps",
    "rope_theta": "rope_theta",
    "tie_word_embeddings": "tie_embeddings",
    "attn_layer_period": "attn_every",
    "attn_layer_offset": "attn_offset",
    "expert_layer_period": "moe_every",
    "expert_layer_offset": "moe_offset",
    "mamba_d_state": "ssm_state",
    "mamba_d_conv": "ssm_conv",
    "mamba_expand": "ssm_expand",
}
# keys that say nothing about the computation the port runs
IGNORED = {"name", "source", "paper", "arch", "model_type", "reduced", "assumed",
           "deployment", "max_position_embeddings", "use_mamba_kernels",
           "num_logits_to_keep", "sliding_window", "router_aux_loss_coef",
           "output_router_logits", "initializer_range", "bos_token_id",
           "eos_token_id", "pad_token_id", "attention_dropout"}


def load(path) -> Dict:
    """The file's keys, with ``assumed`` merged in at the top level."""
    raw = json.loads(Path(path).read_text())
    return {**raw, **raw.get("assumed", {})}


def head_dim(c: Dict) -> int:
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def is_attention(c: Dict, i: int) -> bool:
    period = c.get("attn_layer_period")
    return period is None or i % period == c.get("attn_layer_offset", 0)


def is_moe(c: Dict, i: int) -> bool:
    if not c.get("num_experts"):
        return False
    return i % c.get("expert_layer_period", 1) == c.get("expert_layer_offset", 0)


def _check(c: Dict) -> None:
    """Raise where the file asks for something the port does not compute."""
    want = {"hidden_act": "silu", "attention_bias": False}
    for key, val in want.items():
        if c.get(key, val) != val:
            raise ValueError(f"{key}={c[key]!r}: the port runs {val!r}")
    if c.get("torch_dtype", "bfloat16") not in ("bfloat16", "float16", "float32"):
        raise ValueError(f"torch_dtype {c['torch_dtype']!r}")
    if c.get("attn_layer_period"):
        d = c["hidden_size"]
        if c.get("mamba_dt_rank", d // 16) != max(1, d // 16):
            raise ValueError("the port's mamba dt rank is hidden_size // 16")
        if not c.get("mamba_conv_bias", True) or c.get("mamba_proj_bias", False):
            raise ValueError("the port's mamba has a conv bias and no projection bias")
    unknown = set(c) - set(FIELDS) - IGNORED - {
        "hidden_act", "attention_bias", "torch_dtype", "intermediate_size",
        "num_experts", "num_experts_per_tok", "mamba_dt_rank", "mamba_conv_bias",
        "mamba_proj_bias", "moe_capacity_factor", "head_dim"}
    if unknown:
        raise ValueError(f"keys the harness does not know how to run: {sorted(unknown)}")


def arch_config(c: Dict):
    """The port's ``ArchConfig`` for the file: the registered config of
    ``arch`` with every mapped key replaced by the file's value."""
    from repro_torch.configs.base import MoESpec, get_config

    _check(c)
    base = get_config(c["arch"])
    changes = {field: c[key] for key, field in FIELDS.items() if key in c}
    dtype = c.get("torch_dtype", "bfloat16")
    changes.update(param_dtype=dtype, compute_dtype=dtype, d_head=head_dim(c),
                   d_ff=c["intermediate_size"], moe=None)
    if c.get("num_experts"):
        changes["moe"] = MoESpec(
            n_experts=c["num_experts"], top_k=c["num_experts_per_tok"],
            d_expert=c["intermediate_size"],
            capacity_factor=c.get("moe_capacity_factor", 1.25))
    if not c.get("attn_layer_period"):
        changes.update(attn_every=1, attn_offset=0, default_mixer="attention")
    cfg = dataclasses.replace(base, **changes)
    if cfg.head_dim != head_dim(c):
        raise ValueError(f"head dim {cfg.head_dim} != {head_dim(c)}")
    return cfg


# ---------------------------------------------------------------------------
# parameter counts from the file's numbers (for model FLOPs)
# ---------------------------------------------------------------------------


def layer_matmul_params(c: Dict, i: int) -> int:
    """Weights of layer ``i`` that a token multiplies (of an MoE layer, the
    router and the top-k experts)."""
    d, f = c["hidden_size"], c["intermediate_size"]
    dh = head_dim(c)
    if is_attention(c, i):
        mixer = d * dh * (2 * c["num_attention_heads"] + 2 * c["num_key_value_heads"])
    else:
        di = c["mamba_expand"] * d
        r = c.get("mamba_dt_rank", d // 16)
        n = c["mamba_d_state"]
        mixer = d * 2 * di + di * 2 * n + di * r + r * di + di * d
    if is_moe(c, i):
        mlp = 3 * d * f * c["num_experts_per_tok"] + d * c["num_experts"]
    else:
        mlp = 3 * d * f
    return mixer + mlp


def n_attention_layers(c: Dict) -> int:
    return sum(is_attention(c, i) for i in range(c["num_hidden_layers"]))
