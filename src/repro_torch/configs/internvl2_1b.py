"""InternVL2-1B — InternViT (stub) + Qwen2-0.5B-like LM backbone.

[arXiv:2404.16821; hf]. The vision tower is a STUB per the brief:
``input_specs()`` provides precomputed patch embeddings (n_vision_tokens of
them) which the model prepends to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    n_vision_tokens=256,
    source="arXiv:2404.16821 (hf: OpenGVLab/InternVL2-1B; LM = Qwen2-0.5B)",
)
