"""Kimi K2 1T-A32B — trillion-param MoE, 384 experts top-8. [arXiv:2501.kimi2]

Per the assigned table: 61L, d_model 7168, 64H GQA kv=8, per-expert d_ff 2048,
vocab 163840, 384 experts top-8. Deviations from the real K2 (MLA attention,
dense first layer, shared expert) are intentional — we follow the assigned
table; head_dim is set to 128 explicitly (7168/64 = 112 is MXU-hostile), so
q-proj is 7168->8192 and kv-proj 7168->1024.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,                       # per-expert hidden
    vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, capacity_factor=1.25),
    rope_theta=1_000_000.0,
    source="arXiv:2501.kimi2 (paper-table config; see module docstring)",
)
