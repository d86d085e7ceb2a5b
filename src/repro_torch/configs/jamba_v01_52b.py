"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every 2nd layer [arXiv:2403.19887]."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    activation="swiglu",
    attn_every=8,  # 1 attention : 7 mamba
    attn_offset=4,
    default_mixer="mamba",
    moe=MoESpec(n_experts=16, top_k=2, d_expert=14336),
    moe_every=2,
    moe_offset=1,
)
