"""whisper-large-v3 [audio] — enc-dec transformer backbone; the conv/mel
frontend is a STUB (input_specs provides precomputed frame embeddings)
[arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,  # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    activation="gelu",
    norm="layernorm",
    encoder_decoder=True,
    n_encoder_layers=32,
    frontend="audio",
    n_frontend_tokens=1500,  # 30 s of mel frames after conv stride 2
)
