"""Peaks of the card and the operation and byte counts the rooflines and
``mfu`` divide by, from the shapes in the benchmark's own config files.

NVIDIA H100 SXM (data sheet, dense): 67 TFLOP/s in float32 outside the
tensor cores, 3.35 TB/s of HBM3. The configurations state float32 with
TF32 off, so float32's peak is the one a step is held to.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def matmul_params_per_token(m: Dict) -> int:
    """Weights one token multiplies through (the active parameters, less
    the embedding lookup and the norms): attention projections, the MLP
    or the router and top_k experts, and the LM head over the vocab."""
    d, hd = m["d_model"], head_dim(m)
    attn = d * m["n_heads"] * hd * 2 + d * m["n_kv_heads"] * hd * 2
    if m.get("n_experts"):
        ffn = d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff_expert"]
    else:
        ffn = 3 * d * m["d_ff"]
    return m["n_layers"] * (attn + ffn) + d * m["vocab_size"]


def attention_flops(m: Dict, first: int, last: int) -> float:
    """Causal score and value products of the queries at positions
    ``first..last-1`` (each sees its own position and those before):
    4 · keys · head_dim · heads per layer."""
    keys = (last * (last + 1) - first * (first + 1)) / 2.0
    return 4.0 * keys * head_dim(m) * m["n_heads"] * m["n_layers"]


def generate_flops(m: Dict, prompt_len: int, delivered: int) -> float:
    """Forward FLOPs a request needs: its prompt, then each delivered
    token but the last fed back (the last is only sampled)."""
    tokens = prompt_len + max(delivered - 1, 0)
    return 2.0 * matmul_params_per_token(m) * tokens + attention_flops(m, 0, tokens)


def train_flops(m: Dict, lengths: Sequence[int]) -> float:
    """Forward and backward FLOPs of rows with ``lengths`` real tokens:
    three times the forward."""
    fwd = sum(2.0 * matmul_params_per_token(m) * n + attention_flops(m, 0, n)
              for n in lengths)
    return 3.0 * fwd


def router_xattn_least_s(b: int, dq: int, d: int, k: int) -> float:
    """The least time of one ``router_xattn`` launch: the larger of its
    FLOPs over the fp32 peak and its bytes (every input read once, the
    output written once) over HBM bandwidth. q (B, dq), wq (dq, d),
    K~ and V~ (K, d), wo (d, K), bo (K,) -> (B, K)."""
    flops = 2.0 * b * dq * d + 2.0 * b * k * d * 3
    nbytes = F32 * (b * dq + dq * d + 2 * k * d + d * k + k + b * k)
    return max(flops / PEAK_FLOPS_FP32, nbytes / PEAK_BYTES_PER_S)
