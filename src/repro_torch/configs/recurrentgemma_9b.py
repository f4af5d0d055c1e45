"""RecurrentGemma-9B — RG-LRU + local attention hybrid, 2:1. [arXiv:2402.19427]

Griffin block pattern (rec, rec, attn) cycled over 38 layers; local attention
window 2048, MQA (kv=1). GeGLU MLP, d_ff 12288 (per assigned table).
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    window=2048,
    act="gelu",
    rglru=RGLRUConfig(lru_width=4096, conv_width=4,
                      pattern=("rec", "rec", "attn")),
    rope_theta=10_000.0,
    source="arXiv:2402.19427 (Griffin; hf: google/recurrentgemma-9b)",
)
