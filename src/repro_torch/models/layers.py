"""Core layers: initializers, RMSNorm, RoPE, SwiGLU MLP, embeddings.

Plain functions on nested dicts of tensors, as in ``repro.models.layers``.
Weights are fp32 ``(d_in, d_out)`` and apply as ``x @ w``. Initializers
draw from an explicit ``torch.Generator`` and make the tensor on that
generator's device, so a full-size model is made where it runs.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init, shape (d_in, d_out)."""
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(d_in))


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    """N(0, 0.02) embedding table, shape (vocab, d)."""
    t = torch.empty((vocab, d), dtype=torch.float32, device=gen.device)
    return t.normal_(0.0, 0.02, generator=gen)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device) -> Dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def apply_rmsnorm(params: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` (B, S, H, D) by ``positions`` (B, S), in fp32."""
    inv = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    ang = positions[..., :, None].float() * inv              # (B, S, D/2)
    cos = torch.cos(ang)[..., :, None, :]                    # (B, S, 1, D/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int) -> Dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff),
        "w_up": dense_init(gen, d_model, d_ff),
        "w_down": dense_init(gen, d_ff, d_model),
    }


def apply_mlp(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Token embedding + separate LM head over the padded vocab
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, padded_vocab: int, d_model: int) -> Dict:
    return {
        "table": embed_init(gen, padded_vocab, d_model),
        "head": dense_init(gen, d_model, padded_vocab),
    }


def embed_tokens(params: Dict, token_ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table; int32 ids are widened for ``F.embedding``."""
    return F.embedding(token_ids.long(), params["table"])


def lm_logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["head"]
