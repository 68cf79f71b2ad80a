"""Grouped-query causal self attention with a linear KV cache.

The port of ``repro.models.attention`` for the dense pool members: GQA
with any (n_heads, n_kv_heads), qk RMSNorm over ``head_dim`` (qwen3), and
the linear decode cache with per-slot positions (``slot_pos``) and
per-row pad validity (``pad_valid``) for left-padded batches.

Prefill uses dense attention at every length. Not ported yet (ROADMAP.md
Queue 1, item 6), and refused here: sliding windows with the ring cache,
the banded ``flash_attention`` the reference takes from 2048 tokens, QKV
bias, logit softcap and cross attention.

The port updates the KV cache in place, where the reference returns a new
cache; the functions still return the cache so the call sites read alike.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, ArchConfig, LayerSpec
from repro_torch.models.layers import apply_rmsnorm, apply_rope, dense_init, init_rmsnorm

# Masked logits. Finite on purpose: a left-padded row's pad queries see only
# masked keys, and -inf there would give NaN that reaches real rows through
# 0 * NaN in probs @ v.
NEG_INF = -1e30


def check_supported(cfg: ArchConfig, spec: LayerSpec) -> None:
    """Raise for the attention options this port does not run yet."""
    if spec.mixer != ATTN:
        raise NotImplementedError(
            f"mixer {spec.mixer!r} is not ported yet (ROADMAP.md Queue 1, item 6)")
    if spec.window > 0:
        raise NotImplementedError(
            "sliding-window attention and its ring cache are not ported yet "
            "(ROADMAP.md Queue 1, item 6)")
    if cfg.qkv_bias or cfg.attn_logit_softcap:
        raise NotImplementedError(
            "QKV bias and logit softcap are not ported yet "
            "(ROADMAP.md Queue 1, item 6)")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec) -> Dict:
    check_supported(cfg, spec)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, hq * hd),
        "wk": dense_init(gen, d, hkv * hd),
        "wv": dense_init(gen, d, hkv * hd),
        "wo": dense_init(gen, hq * hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, gen.device)
        p["k_norm"] = init_rmsnorm(hd, gen.device)
    return p


def _project_q(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_kv(cfg: ArchConfig, p: Dict,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        k = apply_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


# ---------------------------------------------------------------------------
# Dense attention
# ---------------------------------------------------------------------------

def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Unchunked GQA attention. q (B,Sq,Hq,D); k,v (B,Sk,Hkv,D);
    mask (B or 1, Sq, Sk) bool, True where a key is visible."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, hd) * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, hd)


def causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """(1, Sq, Sk) bool mask: key j visible to query i iff j <= i."""
    qpos = torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    return (kpos[None, :] <= qpos[:, None])[None]


# ---------------------------------------------------------------------------
# Linear KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
                  device) -> Dict:
    """Preallocated fp32 linear cache of ``max_len`` slots."""
    check_supported(cfg, spec)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, hkv, hd), dtype=torch.float32, device=device),
        "v": torch.zeros((batch, max_len, hkv, hd), dtype=torch.float32, device=device),
        # Absolute position stored in each slot (-1 = empty).
        "slot_pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
        # Per-row slot validity: False where a left-padded prefill wrote a pad.
        "pad_valid": torch.ones((batch, max_len), dtype=torch.bool, device=device),
    }


def prefill_self_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor,
                       kv_valid: Optional[torch.Tensor] = None) -> Dict:
    """Write a prefill's RoPE'd keys and values into the first slots.

    Unlike the reference, which projects the keys again, this takes the
    ``k``/``v`` that :func:`self_attention_prefill` already computed.
    ``kv_valid`` (B, S) bool marks real tokens of a left-padded batch; pad
    slots are written but flagged invalid per row.
    """
    s = k.shape[1]
    n = min(s, cache["k"].shape[1])
    cache["k"][:, :n] = k[:, :n]
    cache["v"][:, :n] = v[:, :n]
    cache["slot_pos"][:n] = positions[0, :n].to(torch.int32)
    if kv_valid is not None:
        cache["pad_valid"][:, :n] = kv_valid[:, :n]
    return cache


def self_attention_prefill(cfg: ArchConfig, spec: LayerSpec, p: Dict,
                           x: torch.Tensor, positions: torch.Tensor, cache: Dict,
                           kv_valid: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Dict]:
    """Causal self attention over the prompt; also fills the decode cache.

    ``kv_valid`` (B, S) bool marks real keys of a left-padded batch. RoPE
    logits depend only on position differences, so masking pad keys makes
    a left-padded row attend exactly as its unpadded self.
    """
    check_supported(cfg, spec)
    b, s, _ = x.shape
    q = apply_rope(_project_q(cfg, p, x), positions, cfg.rope_theta)
    k, v = _project_kv(cfg, p, x)
    k = apply_rope(k, positions, cfg.rope_theta)
    mask = causal_mask(s, s, x.device)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    out = dense_attention(q, k, v, mask).reshape(b, s, -1)
    cache = prefill_self_cache(cache, k, v, positions, kv_valid)
    return out @ p["wo"], cache


def _write_slot(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: int) -> None:
    """Write one token's k, v at linear slot ``pos``, valid for every row."""
    length = cache["k"].shape[1]
    if not 0 <= pos < length:
        raise ValueError(f"decode position {pos} outside the cache's {length} slots")
    cache["k"][:, pos] = k_new[:, 0]
    cache["v"][:, pos] = v_new[:, 0]
    cache["slot_pos"][pos] = pos
    cache["pad_valid"][:, pos] = True


def self_attention_decode(cfg: ArchConfig, spec: LayerSpec, p: Dict,
                          x: torch.Tensor, cache: Dict,
                          pos: int) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x (B,1,D); ``pos`` one position for the whole batch."""
    check_supported(cfg, spec)
    b = x.shape[0]
    pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(_project_q(cfg, p, x), pos_b, cfg.rope_theta)
    k_new, v_new = _project_kv(cfg, p, x)
    k_new = apply_rope(k_new, pos_b, cfg.rope_theta)
    _write_slot(cache, k_new, v_new, pos)
    # Valid = slot holds a position <= pos AND is not a left-padded pad.
    sp = cache["slot_pos"]
    valid = (sp >= 0) & (sp <= pos)
    mask = valid[None, None, :] & cache["pad_valid"][:, None, :]
    out = dense_attention(q, cache["k"], cache["v"], mask).reshape(b, 1, -1)
    return out @ p["wo"], cache
