"""internvl2-1b [vlm] — Qwen2-0.5B-class language backbone; InternViT
frontend is a STUB (input_specs provides patch embeddings)
[arXiv:2404.16821]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    frontend="vision",
    n_frontend_tokens=256,  # 448x448 / 14 patch / pixel-shuffle 4
)
