"""Whisper-base — encoder-decoder ASR backbone, conv frontend STUB.

[arXiv:2212.04356]. Per the brief the mel/conv frontend is a stub:
``input_specs()`` provides precomputed frame embeddings (1500, d_model) as the
encoder input; the transformer backbone (6L enc + 6L dec, d512, 8H MHA,
GELU MLP) is real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                      # decoder layers
    n_encoder_layers=6,
    is_encoder_decoder=True,
    n_encoder_frames=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=0.0,                  # whisper uses learned/sinusoidal positions
    source="arXiv:2212.04356 (hf: openai/whisper-base)",
)
