"""Architecture configuration schema + registry (PyTorch port).

A copy of ``repro.configs.base`` with torch dtype accessors in place of the
``jax.numpy`` ones; every field, the block pattern and ``reduced()`` are the
same, so a test can pin field equality against the reference. Every
config of the reference's registry is registered here.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int  # expert FFN hidden dim
    shared_expert: bool = False  # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # default d_model // n_heads

    activation: str = "swiglu"  # swiglu | sq_relu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- heterogeneous block pattern ---------------------------------
    attn_every: int = 1  # hybrid: attention iff i % attn_every == attn_offset
    attn_offset: int = 0
    default_mixer: str = "attention"  # what non-attention slots use
    slstm_every: int = 0  # xlstm: sLSTM iff slstm_every and i % it == offset
    slstm_offset: int = 7
    moe: Optional[MoESpec] = None
    moe_every: int = 1  # MoE MLP iff i % moe_every == moe_offset
    moe_offset: int = 0

    # --- encoder/decoder & modality frontends -------------------------
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    frontend: Optional[str] = None  # audio | vision (STUB: embeddings given)
    n_frontend_tokens: int = 0

    # --- SSM internals -------------------------------------------------
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    mlstm_chunk: int = 64
    attn_chunk: int = 512  # chunked-attention KV block

    # --- dtypes / numerics ---------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat_stack: bool = True

    # -------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def period(self) -> int:
        """Block-pattern period (layers stacked per kind)."""
        p = 1
        if self.attn_every > 1:
            p = math.lcm(p, self.attn_every)
        if self.slstm_every > 1:
            p = math.lcm(p, self.slstm_every)
        if self.moe is not None and self.moe_every > 1:
            p = math.lcm(p, self.moe_every)
        return p

    @property
    def sub_quadratic(self) -> bool:
        """True if per-token decode cost is O(1)-ish in context (SSM/hybrid):
        eligible for the long_500k shape."""
        return self.family in ("hybrid", "ssm")

    def mixer_kind(self, i: int) -> str:
        if self.slstm_every > 1:
            return "slstm" if i % self.slstm_every == self.slstm_offset else "mlstm"
        if self.attn_every > 1:
            return (
                "attention"
                if i % self.attn_every == self.attn_offset
                else self.default_mixer
            )
        return self.default_mixer

    def mlp_kind(self, i: int) -> str:
        if self.d_ff == 0 and self.moe is None:
            return "none"
        if self.moe is not None and i % self.moe_every == self.moe_offset:
            return "moe"
        return "dense"

    def pattern(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, mlp) for one period."""
        return tuple(
            (self.mixer_kind(i), self.mlp_kind(i)) for i in range(self.period)
        )

    def param_count(self) -> int:
        """Total parameters."""
        return _count_params(self)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k + shared experts only)."""
        return _count_params(self, active_only=True)

    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_expert=64,
                capacity_factor=2.0,
            )
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 * self.period,
            n_encoder_layers=2 if self.encoder_decoder else 0,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            moe=moe,
            n_frontend_tokens=8 if self.frontend else 0,
            ssm_state=8,
            mlstm_chunk=8,
            param_dtype="float32",
            compute_dtype="float32",
        )


def _mixer_params(cfg: ArchConfig, kind: str) -> int:
    d = cfg.d_model
    hd = cfg.head_dim
    if kind == "attention":
        qkv = d * (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd)
        return qkv + cfg.n_heads * hd * d
    if kind == "mamba":
        di = cfg.ssm_expand * d
        return (
            d * 2 * di  # in_proj (x, z)
            + di * cfg.ssm_conv  # depthwise conv
            + di * (2 * cfg.ssm_state + 1)  # W_B, W_C, W_dt(rank-1ish)
            + d * di // 16  # dt projection (low rank)
            + di * cfg.ssm_state  # A_log
            + di  # D skip
            + di * d  # out_proj
        )
    if kind == "mlstm":
        di = 2 * d
        h = cfg.n_heads
        return d * 3 * di + 3 * d * h + di * d  # qkv, gates(i,f,o per head), out
    if kind == "slstm":
        h = cfg.n_heads
        dh = cfg.d_model // h
        return 4 * d * d + 4 * h * dh * dh + d * d  # in gates, recurrent, out
    return 0


def _mlp_params(cfg: ArchConfig, kind: str) -> int:
    d = cfg.d_model
    if kind == "dense":
        mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
        return mult * d * cfg.d_ff
    if kind == "moe":
        moe = cfg.moe
        mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
        per_expert = mult * d * moe.d_expert
        total = moe.n_experts * per_expert + d * moe.n_experts  # + router
        if moe.shared_expert:
            total += per_expert
        return total
    return 0


def _mlp_active_params(cfg: ArchConfig, kind: str) -> int:
    if kind != "moe":
        return _mlp_params(cfg, kind)
    moe = cfg.moe
    mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
    per_expert = mult * cfg.d_model * moe.d_expert
    active = moe.top_k * per_expert + cfg.d_model * moe.n_experts
    if moe.shared_expert:
        active += per_expert
    return active


def _count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    total = cfg.vocab * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab * cfg.d_model
    layers = []
    for i in range(cfg.n_layers):
        layers.append((cfg.mixer_kind(i), cfg.mlp_kind(i)))
    for mixer, mlp in layers:
        total += _mixer_params(cfg, mixer)
        total += (
            _mlp_active_params(cfg, mlp) if active_only else _mlp_params(cfg, mlp)
        )
        total += 2 * cfg.d_model  # norms
    if cfg.encoder_decoder:
        for _ in range(cfg.n_encoder_layers):
            total += _mixer_params(cfg, "attention") + _mlp_params(cfg, "dense")
            total += 2 * cfg.d_model
        total += cfg.n_layers * (_mixer_params(cfg, "attention") + cfg.d_model)
    return total


# ---------------------------------------------------------------------------
# registry: the reference's ten archs
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "yi_6b",
    "qwen3_moe_235b_a22b",
    "jamba_v01_52b",
    "llama4_maverick_400b_a17b",
    "nemotron_4_15b",
    "qwen25_14b",
    "stablelm_3b",
    "xlstm_13b",
    "whisper_large_v3",
    "internvl2_1b",
)

_ALIASES = {
    "yi-6b": "yi_6b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen2.5-14b": "qwen25_14b",
    "stablelm-3b": "stablelm_3b",
    "xlstm-1.3b": "xlstm_13b",
    "whisper-large-v3": "whisper_large_v3",
    "internvl2-1b": "internvl2_1b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r} (known: {ARCH_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
