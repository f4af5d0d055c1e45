"""Model / run configuration dataclasses.

One ``ModelConfig`` covers every assigned architecture family:
dense transformer LMs (with GQA/MQA, optional QKV bias, optional local window),
MoE transformers, Mamba2 (SSD), RG-LRU hybrids (recurrentgemma), and
encoder-decoder (whisper). Modality frontends (audio conv, vision tower) are
STUBS per the brief: ``input_specs()`` supplies precomputed frame/patch
embeddings.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # experts' hidden size lives in ModelConfig.d_ff (per-expert width)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD parameters."""
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256              # SSD chunk length (training/prefill)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin recurrent-block parameters."""
    lru_width: int = 0            # 0 => d_model
    conv_width: int = 4
    c_exponent: float = 8.0       # a = sigmoid(L)^(c * r_t)
    # block pattern: cycle of layer kinds, truncated to n_layers
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    act: str = "swiglu"           # swiglu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    window: int = 0               # 0 => full causal attention; >0 => local window
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_encoder_frames: int = 1500  # stubbed audio frontend output length
    # vlm stub
    n_vision_tokens: int = 0      # prepended patch-embedding tokens
    # numerics
    dtype: str = "bfloat16"
    # notes for DESIGN/EXPERIMENTS (citations, deviations)
    source: str = ""

    # ---- derived helpers -------------------------------------------------
    def norm_style(self) -> str:
        return self.norm

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode with O(1)/O(window) state (long_500k)."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind sequence (for hybrids)."""
        if self.family == "hybrid":
            assert self.rglru is not None
            pat = self.rglru.pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.family == "moe":
            return ("moe",) * self.n_layers
        return ("attn",) * self.n_layers

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks), for MODEL_FLOPS."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * D * (1 if self.tie_embeddings else 2)
        per_layer = 0
        kinds = self.layer_kinds()
        for kind in kinds:
            if kind in ("attn",):
                per_layer_attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
                if self.qkv_bias:
                    per_layer_attn += self.q_dim + 2 * self.kv_dim
                mlp = 3 * D * F if self.act == "swiglu" else 2 * D * F
                per_layer += per_layer_attn + mlp + 2 * D
            elif kind == "moe":
                assert self.moe is not None
                attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
                experts = self.moe.n_experts * 3 * D * F
                router = D * self.moe.n_experts
                per_layer += attn + experts + router + 2 * D
            elif kind == "ssm":
                assert self.ssm is not None
                di = self.ssm.d_inner(D)
                nh = self.ssm.n_heads(D)
                in_proj = D * (2 * di + 2 * self.ssm.state_dim + nh)
                conv = self.ssm.conv_width * (di + 2 * self.ssm.state_dim)
                out_proj = di * D
                per_layer += in_proj + conv + out_proj + nh * 2 + di + 2 * D
            elif kind == "rec":
                assert self.rglru is not None
                w = self.rglru.lru_width or D
                per_layer += D * 2 * w + self.rglru.conv_width * w + 2 * w * w + w * D
                mlp = 3 * D * F if self.act == "swiglu" else 2 * D * F
                per_layer += mlp + 2 * D
        total = emb + per_layer + D  # final norm
        if self.is_encoder_decoder:
            # encoder self-attn+mlp + decoder cross-attn
            enc = self.n_encoder_layers * (
                4 * D * D * 1  # qkvo with n_heads*head_dim == D for whisper
                + (2 * D * F if self.act == "gelu" else 3 * D * F) + 2 * D)
            cross = self.n_layers * (D * self.q_dim + 2 * D * self.kv_dim
                                     + self.q_dim * D + D)
            total += enc + cross
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.n_params()
        assert self.moe is not None
        D, F = self.d_model, self.d_ff
        dense_like = self.n_params() - self.n_layers * (
            self.moe.n_experts - self.moe.top_k) * 3 * D * F
        return int(dense_like)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned (input-shape) cell."""
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    """How a run is laid out on the mesh."""
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: Optional[str] = None       # set for multi-pod meshes
    fsdp: bool = True                    # shard params/opt over data axis
    fsdp_pod: bool = True                # extend FSDP over the pod axis too
    tensor_parallel: bool = True
    expert_parallel: bool = True
    sequence_parallel: bool = False      # SP on activations (hillclimb lever)
    shard_kv_seq_on_decode: bool = True  # kv_heads < model axis => shard KV seq
    remat: str = "block"                 # none | block | full | dots
    grad_accum: int = 1
    optimizer: str = "adamw"             # adamw | adafactor
    opt_state_dtype: str = "float32"     # float32 | bfloat16
    grad_compress: str = "none"          # none | int8_ef (cross-pod allreduce)
    fused_xent: bool = False             # chunked-vocab fused softmax-xent (hillclimb)
    scan_layers: bool = True
    param_dtype: str = "float32"         # float32 | bfloat16 (dry-runs: bf16)
    compute_dtype: str = "bfloat16"      # forward-pass dtype
    q_block: int = 512                   # flash-attention q block (XLA path)
    kv_block: int = 1024                 # flash-attention kv block (XLA path)
    # --- hillclimb levers (defaults = paper-faithful baseline) ---
    explicit_rs: bool = False            # shard_map out-projections with
    #                                      psum_scatter (Megatron-SP) instead
    #                                      of GSPMD all-reduce
    moe_decode_cap_mult: float = 4.0     # decode expert-capacity multiplier
    pad_attention_heads: bool = False    # pad Hq up to a TP multiple so cp
    #                                      archs can run the tp recipe
    moe_weight_stationary: bool = False  # decode MoE: shard expert d_ff over
    #                                      `data` and move activations, not
    #                                      weights (kills the per-step FSDP
    #                                      weight gather at inference)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small: dict = dict(
        n_layers=2 if not cfg.rglru else 3,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        n_encoder_frames=16 if cfg.is_encoder_decoder else cfg.n_encoder_frames,
        n_vision_tokens=4 if cfg.n_vision_tokens else 0,
        name=cfg.name + "-smoke",
        dtype="float32",
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(n_experts=4, top_k=2,
                                 capacity_factor=cfg.moe.capacity_factor)
        small["d_ff"] = 64
    if cfg.ssm is not None:
        small["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2,
                                 conv_width=cfg.ssm.conv_width, chunk=8)
    if cfg.rglru is not None:
        small["rglru"] = RGLRUConfig(lru_width=0, conv_width=cfg.rglru.conv_width,
                                     pattern=cfg.rglru.pattern)
        small["window"] = 8
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
