"""Granite-20B-Code — llama-arch MQA (kv=1) code model. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=False,
    rope_theta=10_000.0,
    source="arXiv:2405.04324 (hf: ibm-granite/granite-20b-code-base)",
)
