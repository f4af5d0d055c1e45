"""Model FLOPs of the work a run did, from the configuration alone.

Two operations a multiply-add. Per token: every weight matrix the token
passes through (for an MoE layer the router and its top-k experts), the
attention over the positions it sees (4 x heads x head_dim a position:
scores and values), for a state-space layer the depthwise conv and the
state's update and read-out (4 x heads x P x N); plus the output head
for each position whose logits the step computes. Embedding lookups,
norms and activations are not counted.
"""
from __future__ import annotations


def _per_token_linear(m: dict) -> int:
    D = m["d_model"]
    L = m["n_layers"]
    fam = m["family"]
    if fam in ("dense", "moe"):
        Q = m["n_heads"] * m["head_dim"]
        KV = m["n_kv_heads"] * m["head_dim"]
        attn = D * Q + 2 * D * KV + Q * D
        if fam == "moe":
            e = m["moe"]
            ffn = D * e["n_experts"] + e["top_k"] * 3 * D * m["d_ff"]
        else:
            ffn = 3 * D * m["d_ff"]
        return 2 * L * (attn + ffn)
    if fam == "ssm":
        s = m["ssm"]
        di = s["expand"] * D
        H = di // s["head_dim"]
        N = s["state_dim"]
        proj = D * (2 * di + 2 * N + H) + di * D
        conv = s["conv_width"] * (di + 2 * N)
        scan = 2 * H * s["head_dim"] * N
        return 2 * L * (proj + conv + scan)
    raise ValueError(f"no FLOP formula for family {fam!r}")


def _attention(m: dict, positions_seen: int) -> int:
    if m["family"] not in ("dense", "moe"):
        return 0
    return 4 * m["n_layers"] * m["n_heads"] * m["head_dim"] * positions_seen


def _head(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab_size"]


def prefill(m: dict, batch: int, length: int) -> int:
    """A prefill of ``batch`` prompts of ``length`` tokens whose logits are
    taken at the last position."""
    seen = length * (length + 1) // 2
    return batch * (length * _per_token_linear(m) + _attention(m, seen)
                    + _head(m))


def decode_token(m: dict, position: int) -> int:
    """One decoded token at ``position`` (it sees position + 1 keys)."""
    return _per_token_linear(m) + _attention(m, position + 1) + _head(m)
