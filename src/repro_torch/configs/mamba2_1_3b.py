"""Mamba2-1.3B — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060 (mamba2-1.3b: 48L d2048 N=128 P=64 expand=2)",
)
