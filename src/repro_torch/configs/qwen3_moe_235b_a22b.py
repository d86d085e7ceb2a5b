"""qwen3-moe-235b-a22b [moe] — 94L, 128 experts top-8, expert d_ff=1536,
head_dim 128 [hf:Qwen/Qwen3-30B-A3B family]."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=0,  # every MLP is MoE
    vocab=151936,
    activation="swiglu",
    rope_theta=1e6,
    moe=MoESpec(n_experts=128, top_k=8, d_expert=1536),
    moe_every=1,
)
