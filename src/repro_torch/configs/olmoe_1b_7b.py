"""OLMoE-1B-7B — 64-expert top-8 MoE. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,                       # per-expert hidden
    vocab_size=50304,
    moe=MoEConfig(n_experts=64, top_k=8, capacity_factor=1.25),
    rope_theta=10_000.0,
    source="arXiv:2409.02060 (hf: allenai/OLMoE-1B-7B-0924)",
)
