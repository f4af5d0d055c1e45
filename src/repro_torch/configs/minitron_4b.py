"""Minitron-4B — pruned Nemotron dense GQA transformer. [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    qkv_bias=False,
    act="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2407.14679 (hf: nvidia/Minitron-4B-Base)",
)
