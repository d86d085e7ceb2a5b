"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
dense/MoE interleave (every 2nd layer), early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family]."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    activation="swiglu",
    rope_theta=5e5,
    moe=MoESpec(n_experts=128, top_k=1, d_expert=8192, shared_expert=True),
    moe_every=2,
    moe_offset=1,
)
