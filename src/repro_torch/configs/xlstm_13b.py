"""xlstm-1.3b [ssm] — mLSTM/sLSTM 7:1 block stack, no FFN (mLSTM up-proj
carries the capacity) [arXiv:2405.04517]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    default_mixer="mlstm",
    slstm_every=8,
    slstm_offset=7,
    norm="layernorm",
)
