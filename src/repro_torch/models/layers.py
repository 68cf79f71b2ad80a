"""Core layers: initializers, RMSNorm, RoPE, SwiGLU MLP, embeddings, the
token cross-entropy.

Plain functions on nested dicts of tensors, as in ``repro.models.layers``.
Weights are fp32 ``(d_in, d_out)`` and apply as ``x @ w``. Initializers
draw from an explicit ``torch.Generator`` and make the tensor on that
generator's device, so a full-size model is made where it runs.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding_ctx import gather_fsdp, shard

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init, σ = scale / sqrt(d_in), shape
    (d_in, d_out)."""
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return w.mul_(scale / math.sqrt(d_in))


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
    h = shard(h, "batch", "seq", "ff")
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Depthwise causal conv (the Mamba and mLSTM fronts)
# ---------------------------------------------------------------------------

def causal_conv(p: Dict, xi: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of ``p["conv_w"]`` (dc, C) along time over xi
    (B, S, C), as a sum of shifted products with ``dc - 1`` zeros in front,
    as the reference writes it (``F.conv1d`` would take cuDNN's TF32 default)."""
    dc = p["conv_w"].shape[0]
    xp = F.pad(xi, (0, 0, dc - 1, 0))
    s = xi.shape[1]
    return sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(dc))


def conv_step(p: Dict, window: torch.Tensor) -> torch.Tensor:
    """The conv at one position: window (B, dc, C) of the last dc inputs ->
    (B, 1, C)."""
    return (window * p["conv_w"]).sum(dim=1, keepdim=True)


def conv_tail(xi: torch.Tensor, dc: int) -> torch.Tensor:
    """The last ``dc - 1`` conv inputs of xi (B, S, C), zeros in front of a
    shorter prompt: the decode conv's starting window. A copy, not a view:
    a decode cache that held a view of xi would keep all of it alive."""
    s = xi.shape[1]
    return xi[:, s - (dc - 1):].clone() if s >= dc - 1 else F.pad(xi, (0, 0, dc - 1 - s, 0))


# ---------------------------------------------------------------------------
# Token embedding + separate LM head over the padded vocab
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, padded_vocab: int, d_model: int) -> Dict:
    return {
        "table": embed_init(gen, padded_vocab, d_model),
        "head": dense_init(gen, d_model, padded_vocab),
    }


def embed_tokens(params: Dict, token_ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table; int32 ids are widened for ``F.embedding``.

    On a mesh the table is gathered over the FSDP axes first, so it is
    sharded on the vocab only and the batch-sharded ids look up in it in
    place: each rank masks the rows its vocab shard holds, and the
    caller's ``shard`` sums the masked partial rows."""
    return F.embedding(token_ids.long(), gather_fsdp(params["table"]))


def lm_logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ gather_fsdp(params["head"])


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def token_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        vocab_size: int) -> torch.Tensor:
    """Per-position cross entropy (..., padded_vocab) -> (...) in fp32,
    with the padded vocab columns pushed down by 1e30."""
    lg = logits.float()
    pad = lg.shape[-1] - vocab_size
    if pad > 0:
        lg = lg - torch.cat([lg.new_zeros((vocab_size,)), lg.new_full((pad,), 1e30)])
    if isinstance(lg, DTensor):
        # On a mesh the logits are vocab-sharded: each rank picks the gold
        # logit from its own columns (zero elsewhere) and takes the
        # log-sum-exp's max and sum over its own columns; the reductions
        # over the vocab then add up the ranks' parts, so no rank holds a
        # whole vocab row (vocab-parallel cross entropy). DTensor's own
        # logsumexp gathers the logits first.
        axes = ("batch", "seq")[:lg.ndim - 1]
        cols = torch.arange(lg.shape[-1], device=lg.device)
        gold = torch.where(cols == labels.long()[..., None], lg, 0.0).sum(dim=-1)
        top = shard(lg.amax(dim=-1).detach(), *axes)
        lse = torch.log(shard(torch.exp(lg - top[..., None]).sum(dim=-1), *axes)) + top
        return lse - shard(gold, *axes)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(lg, dim=-1) - gold


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                          mask: Optional[torch.Tensor] = None,
                          seq_chunk: int = 0) -> torch.Tensor:
    """Mean next-token cross entropy over (B, S, padded_vocab) logits.

    ``seq_chunk`` > 0 takes the loss ``seq_chunk`` positions at a time,
    with a shorter tail, so the fp32 log-sum-exp intermediate is one
    chunk's. ``mask`` (B, S) marks the positions that count: the mean is
    ``sum(loss * mask) / max(sum(mask), 1)``.
    """
    s = labels.shape[1]
    if seq_chunk and s > seq_chunk:
        losses = torch.cat([token_cross_entropy(logits[:, lo:lo + seq_chunk],
                                                labels[:, lo:lo + seq_chunk], vocab_size)
                            for lo in range(0, s, seq_chunk)], dim=1)
    else:
        losses = token_cross_entropy(logits, labels, vocab_size)
    if mask is not None:
        mask = mask.float()
        return (losses * mask).sum() / mask.sum().clamp(min=1.0)
    return losses.mean()
