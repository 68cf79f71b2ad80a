"""Grouped-query attention: causal self attention, full and sliding-window,
with a linear or ring KV cache, and cross attention to stub media.

The port of ``repro.models.attention``:

  * GQA with any (n_heads, n_kv_heads)          [all dense members]
  * QKV bias                                    [qwen1.5-4b]
  * qk RMSNorm over ``head_dim``                [qwen3-0.6b, gemma3-27b]
  * logit softcap ``tanh(s / c) * c``           [none of the pool; unit-tested]
  * sliding window with a ring-buffer cache     [gemma3-27b locals]
  * cross attention to projected media tokens   [llama-3.2-vision]

Training and prefill take dense attention below ``FLASH_MIN_SEQ`` tokens
and the chunked online-softmax ``flash_attention`` from there, as the
reference does: a Python loop over q chunks, each over its band of k
chunks only, so a windowed layer skips the chunks left of its window.
Prefill is the training path's attention, then its keys and values
written into the decode cache. Decode reads a
preallocated cache with per-slot positions (``slot_pos``) and per-row pad
validity (``pad_valid``) for left-padded batches; windowed layers keep a
ring of ``min(window, max_len)`` slots. Cross attention projects the
media, ``(B, n_frontend_tokens, frontend_dim)`` from the stub encoder,
through ``w_proj`` and an RMSNorm, attends to all of it densely (no RoPE,
no mask), and keeps its K/V in a cache of one slot per media token that
prefill fills once and decode only reads.

The port updates the KV cache in place, where the reference returns a new
cache; the functions still return the cache so the call sites read alike.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import XATTN, ArchConfig, LayerSpec
from repro_torch.models import runtime_flags
from repro_torch.models.layers import apply_rmsnorm, apply_rope, dense_init, init_rmsnorm
from repro_torch.models.sharding_ctx import batch_local, merge, shard, unflatten

# Masked logits. Finite on purpose: a left-padded row's pad queries see only
# masked keys, and -inf there would give NaN that reaches real rows through
# 0 * NaN in probs @ v. In flash_attention a fully masked band chunk adds
# probs of exp(0) = 1, which the next chunk's alpha = exp(-1e30 - m) = 0
# wipes; with -inf that chunk would give NaN.
NEG_INF = -1e30

# Prefill length from which the chunked path is taken; its chunks are 1024.
FLASH_MIN_SEQ = 2048
FLASH_CHUNK = 1024


def check_frontend(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` can carry a cross-attention layer: its projector
    maps ``frontend_dim``-wide media into ``d_model`` and its cache holds
    ``n_frontend_tokens`` slots. The reference makes such a layer without
    the projector and fails later, with a ``KeyError`` on ``w_proj``."""
    if cfg.frontend_dim <= 0 or cfg.n_frontend_tokens <= 0:
        raise ValueError(
            f"{cfg.name}: a cross-attention (XATTN) layer needs frontend_dim > 0 "
            f"and n_frontend_tokens > 0 (the media its projector reads); got "
            f"frontend_dim={cfg.frontend_dim}, n_frontend_tokens={cfg.n_frontend_tokens}")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec) -> Dict:
    """Seeded projections; QKV biases start at zero, as in the reference. A
    cross-attention layer also gets the media projector ``w_proj`` and its
    norm ``proj_norm``."""
    if spec.mixer == XATTN:
        check_frontend(cfg)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, d, hq * hd),
        "wk": dense_init(gen, d, hkv * hd),
        "wv": dense_init(gen, d, hkv * hd),
        "wo": dense_init(gen, hq * hd, d),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=torch.float32, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=torch.float32, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=torch.float32, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dev)
        p["k_norm"] = init_rmsnorm(hd, dev)
    if spec.mixer == XATTN:
        p["w_proj"] = dense_init(gen, cfg.frontend_dim, d)
        p["proj_norm"] = init_rmsnorm(d, dev)
    return p


def _project_q(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = unflatten(q, -1, (cfg.n_heads, cfg.resolved_head_dim))
    if cfg.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_kv(cfg: ArchConfig, p: Dict,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = unflatten(k, -1, (hkv, hd))
    v = unflatten(v, -1, (hkv, hd))
    if cfg.qk_norm:
        k = apply_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


# ---------------------------------------------------------------------------
# Dense attention
# ---------------------------------------------------------------------------

def _softcap(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    return torch.tanh(scores / softcap) * softcap if softcap > 0.0 else scores


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], softcap: float = 0.0) -> torch.Tensor:
    """Unchunked GQA attention. q (B,Sq,Hq,D); k,v (B,Sk,Hkv,D);
    mask (B or 1, Sq, Sk) bool, True where a key is visible. ``softcap``
    > 0 caps the logits before masking. On a mesh it runs on each rank's
    batch shard (``batch_local``)."""
    if isinstance(q, DTensor):
        return batch_local(dense_attention, (q, k, v, mask, softcap), (0, 0, 0, 0, None))
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, hd) * (1.0 / math.sqrt(hd))
    scores = _softcap(torch.einsum("bqhgd,bkhd->bhgqk", qg, k), softcap)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, hd)


def causal_mask(sq: int, sk: int, device, window: int = 0) -> torch.Tensor:
    """(1, Sq, Sk) bool mask: key j visible to query i iff j <= i, and
    j > i - window when ``window`` > 0."""
    qpos = torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    m = kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    return m[None]


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (banded)
# ---------------------------------------------------------------------------

def prefill_width(s: int) -> int:
    """The width a prompt batch of ``s`` tokens is left-padded to: ``s``
    itself below ``FLASH_MIN_SEQ``, else ``s`` rounded up to a multiple of
    ``FLASH_CHUNK``, the length :func:`flash_attention` holds prefill to.
    Pads are masked keys, so the extra width leaves every real row as it was.
    """
    return s if s < FLASH_MIN_SEQ else -(-s // FLASH_CHUNK) * FLASH_CHUNK


def flash_band(q_lo: int, q_hi: int, window: int, k_chunk: int) -> range:
    """The k chunks the q chunk ``[q_lo, q_hi)`` visits: from the first that
    holds a key inside its window, ``max(0, (q_lo - window) // k_chunk)``,
    to its causal bound."""
    lo = 0 if window <= 0 else max(0, (q_lo - window) // k_chunk)
    return range(lo, (q_hi + k_chunk - 1) // k_chunk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, q_chunk: int = FLASH_CHUNK,
                    k_chunk: int = FLASH_CHUNK, softcap: float = 0.0,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over the band only.

    q (B,S,Hq,D); k,v (B,S,Hkv,D); ``kv_valid`` (B, S) bool marks real
    keys of a left-padded batch. Each q chunk visits only the k chunks of
    its :func:`flash_band`, carrying the running max, normaliser and fp32
    accumulator across them, as the reference's ``lax.scan`` does. S must be a multiple of both chunks
    (each taken as at most S), as the reference asserts. On a mesh it runs
    on each rank's batch shard (``batch_local``).
    """
    if isinstance(q, DTensor):
        return batch_local(
            lambda q_, k_, v_, valid: flash_attention(
                q_, k_, v_, window=window, q_chunk=q_chunk, k_chunk=k_chunk,
                softcap=softcap, kv_valid=valid),
            (q, k, v, kv_valid), (0, 0, 0, 0))
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q_chunk, k_chunk = runtime_flags.flash_chunk(q_chunk), runtime_flags.flash_chunk(k_chunk)
    q_chunk, k_chunk = min(q_chunk, s), min(k_chunk, s)
    if s % q_chunk or s % k_chunk:
        raise ValueError(
            f"flash_attention needs the sequence length to be a multiple of its "
            f"chunks: S = {s}, q_chunk = {q_chunk}, k_chunk = {k_chunk} (prefill "
            f"takes it from {FLASH_MIN_SEQ} tokens with chunks of {FLASH_CHUNK})")
    dev = q.device
    qg = (q * (1.0 / math.sqrt(hd))).reshape(b, s, hkv, g, hd)
    outs = []
    for qi in range(s // q_chunk):
        q_lo, q_hi = qi * q_chunk, (qi + 1) * q_chunk
        qc = qg[:, q_lo:q_hi]
        qpos = torch.arange(q_lo, q_hi, device=dev)
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        denom = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, hd), dtype=torch.float32, device=dev)
        for ci in flash_band(q_lo, q_hi, window, k_chunk):
            start = ci * k_chunk
            kc, vc = k[:, start:start + k_chunk], v[:, start:start + k_chunk]
            scores = _softcap(torch.einsum("bqhgd,bkhd->bhgqk", qc, kc), softcap)
            kpos = torch.arange(start, start + k_chunk, device=dev)
            msk = kpos[None, :] <= qpos[:, None]
            if window > 0:
                msk &= kpos[None, :] > qpos[:, None] - window
            scores = torch.where(msk, scores, NEG_INF)
            if kv_valid is not None:
                valid = kv_valid[:, start:start + k_chunk]
                scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            probs = torch.exp(scores - m_new[..., None])
            denom = denom * alpha + probs.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", probs, vc)
            m = m_new
        out = acc / torch.clamp(denom, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, hq, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# KV caches (linear, or a ring for windowed layers)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
                  device) -> Dict:
    """Preallocated fp32 cache: ``max_len`` slots, or a ring of
    ``min(window, max_len)`` for a sliding-window layer, or one slot per
    media token (no positions, no pads) for a cross-attention layer."""
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if spec.mixer == XATTN:
        check_frontend(cfg)
        n = cfg.n_frontend_tokens
        return {
            "k": torch.zeros((batch, n, hkv, hd), dtype=torch.float32, device=device),
            "v": torch.zeros((batch, n, hkv, hd), dtype=torch.float32, device=device),
        }
    length = min(spec.window, max_len) if spec.window > 0 else max_len
    return {
        "k": torch.zeros((batch, length, hkv, hd), dtype=torch.float32, device=device),
        "v": torch.zeros((batch, length, hkv, hd), dtype=torch.float32, device=device),
        # Absolute position stored in each slot (-1 = empty).
        "slot_pos": torch.full((length,), -1, dtype=torch.int32, device=device),
        # Per-row slot validity: False where a left-padded prefill wrote a pad.
        "pad_valid": torch.ones((batch, length), dtype=torch.bool, device=device),
    }


def prefill_self_cache(spec: LayerSpec, cache: Dict, k: torch.Tensor,
                       v: torch.Tensor, positions: torch.Tensor,
                       kv_valid: Optional[torch.Tensor] = None) -> Dict:
    """Write a prefill's RoPE'd keys and values into the decode cache.

    A ring that the prompt fills keeps only the trailing ``length``
    positions (the only ones a later decode step may attend to), each at
    slot ``pos % length``; otherwise the prompt takes the first slots.
    Unlike the reference, which projects the keys again, this takes the
    ``k``/``v`` that :func:`self_attention_prefill` already computed.
    ``kv_valid`` (B, S) bool marks real tokens of a left-padded batch; pad
    slots are written but flagged invalid per row.
    """
    s = k.shape[1]
    length = cache["k"].shape[1]
    valid = (torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
             if kv_valid is None else kv_valid.to(torch.bool))
    if spec.window > 0 and s >= length:
        tail_pos = positions[0, s - length:]
        order = torch.argsort(tail_pos % length)
        cache["k"].copy_(k[:, s - length:][:, order])
        cache["v"].copy_(v[:, s - length:][:, order])
        cache["slot_pos"].copy_(tail_pos[order].to(torch.int32))
        cache["pad_valid"].copy_(valid[:, s - length:][:, order])
        return cache
    n = min(s, length)
    _write_prefix(cache["k"], k, n, 1)
    _write_prefix(cache["v"], v, n, 1)
    _write_prefix(cache["slot_pos"], positions[0].to(torch.int32), n, 0)
    _write_prefix(cache["pad_valid"], valid, n, 1)
    return cache


def _write_prefix(dst: torch.Tensor, src: torch.Tensor, n: int, dim: int) -> None:
    """Copy ``src``'s first ``n`` entries along ``dim`` into ``dst``'s. On
    a mesh ``dst``'s slots may be sharded, so a write into the prefix's
    view would land in a redistributed copy: ``dst`` is rewritten whole,
    into its own placements."""
    if isinstance(dst, DTensor):
        rest = dst.narrow(dim, n, dst.shape[dim] - n)
        dst.copy_(torch.cat([src.narrow(dim, 0, n), rest], dim=dim))
    else:
        dst.narrow(dim, 0, n).copy_(src.narrow(dim, 0, n))


def _self_attention(cfg: ArchConfig, spec: LayerSpec, p: Dict, x: torch.Tensor,
                    positions: torch.Tensor, kv_valid: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal (windowed) self attention over a full sequence: (out (B,S,D),
    the RoPE'd keys, the values). Dense below ``FLASH_MIN_SEQ`` tokens,
    ``flash_attention`` from there."""
    b, s, _ = x.shape
    q = apply_rope(_project_q(cfg, p, x), positions, cfg.rope_theta)
    k, v = _project_kv(cfg, p, x)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    if s >= FLASH_MIN_SEQ:
        out = flash_attention(q, k, v, window=spec.window,
                              softcap=cfg.attn_logit_softcap, kv_valid=kv_valid)
    else:
        mask = causal_mask(s, s, x.device, window=spec.window)
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, :]
        out = dense_attention(q, k, v, mask, cfg.attn_logit_softcap)
    return merge(out, 2) @ p["wo"], k, v


def self_attention_full_seq(cfg: ArchConfig, spec: LayerSpec, p: Dict,
                            x: torch.Tensor, positions: torch.Tensor,
                            kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal (windowed) self attention over a full sequence (the train
    path). Dense below ``FLASH_MIN_SEQ`` tokens, ``flash_attention`` from
    there.

    ``kv_valid`` (B, S) bool marks real keys of a left-padded batch. RoPE
    logits depend only on position differences, so masking pad keys makes
    a left-padded row attend exactly as its unpadded self.
    """
    return _self_attention(cfg, spec, p, x, positions, kv_valid)[0]


def self_attention_prefill(cfg: ArchConfig, spec: LayerSpec, p: Dict,
                           x: torch.Tensor, positions: torch.Tensor, cache: Dict,
                           kv_valid: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Dict]:
    """:func:`self_attention_full_seq` over the prompt, then its keys and
    values into the decode cache (:func:`prefill_self_cache`)."""
    out, k, v = _self_attention(cfg, spec, p, x, positions, kv_valid)
    return out, prefill_self_cache(spec, cache, k, v, positions, kv_valid)


def _write_slot(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: int, ring: bool) -> None:
    """Write one token's k, v at slot ``pos % length`` of a ring, or at
    linear slot ``pos``; the slot becomes valid for every row."""
    length = cache["k"].shape[1]
    if ring:
        slot = pos % length
    elif 0 <= pos < length:
        slot = pos
    else:
        raise ValueError(f"decode position {pos} outside the cache's {length} slots")
    if isinstance(cache["k"], DTensor):
        # On a mesh the slots may be sharded ("cache_seq" on "model"), so a
        # write into one slot's view would land in a redistributed copy:
        # each tensor is rewritten whole, as the reference's
        # dynamic_update_slice does, into its own placements.
        hit = torch.arange(length, device=k_new.device) == slot
        cache["k"].copy_(torch.where(hit[None, :, None, None], k_new, cache["k"]))
        cache["v"].copy_(torch.where(hit[None, :, None, None], v_new, cache["v"]))
        cache["slot_pos"].copy_(torch.where(hit, pos, cache["slot_pos"]))
        cache["pad_valid"].copy_(cache["pad_valid"] | hit[None, :])
        return
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["slot_pos"][slot] = pos
    cache["pad_valid"][:, slot] = True


def self_attention_decode(cfg: ArchConfig, spec: LayerSpec, p: Dict,
                          x: torch.Tensor, cache: Dict,
                          pos: int) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x (B,1,D); ``pos`` one position for the whole batch."""
    b = x.shape[0]
    pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(_project_q(cfg, p, x), pos_b, cfg.rope_theta)
    k_new, v_new = _project_kv(cfg, p, x)
    k_new = apply_rope(k_new, pos_b, cfg.rope_theta)
    _write_slot(cache, k_new, v_new, pos, spec.window > 0)
    k = shard(cache["k"], "batch", "cache_seq", "kv_heads", None)
    v = shard(cache["v"], "batch", "cache_seq", "kv_heads", None)
    # Valid = slot holds a position in (pos - W, pos] AND is not a pad.
    sp = cache["slot_pos"]
    valid = (sp >= 0) & (sp <= pos)
    if spec.window > 0:
        valid &= sp > pos - spec.window
    mask = valid[None, None, :] & cache["pad_valid"][:, None, :]
    out = dense_attention(q, k, v, mask, cfg.attn_logit_softcap)
    return merge(out, 2) @ p["wo"], cache


# ---------------------------------------------------------------------------
# Cross attention to media tokens
# ---------------------------------------------------------------------------

def _media_kv(cfg: ArchConfig, p: Dict,
              media: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys and values of the projected media: RMSNorm(media @ w_proj),
    then the layer's K/V projections. No RoPE across modalities."""
    mtok = apply_rmsnorm(p["proj_norm"], media @ p["w_proj"], cfg.norm_eps)
    return _project_kv(cfg, p, mtok)


def _attend_media(cfg: ArchConfig, p: Dict, x: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    out = dense_attention(_project_q(cfg, p, x), k, v, None, cfg.attn_logit_softcap)
    return merge(out, 2) @ p["wo"]


def cross_attention_full_seq(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                             media: torch.Tensor) -> torch.Tensor:
    """Text queries x (B,S,D) attend to every projected media token;
    ``media`` (B, n_frontend_tokens, frontend_dim) from the stub encoder."""
    return _attend_media(cfg, p, x, *_media_kv(cfg, p, media))


def prefill_cross_cache(cfg: ArchConfig, p: Dict, media: torch.Tensor,
                        cache: Dict) -> Dict:
    """Write the projected media's keys and values into the cross cache."""
    k, v = _media_kv(cfg, p, media)
    cache["k"].copy_(k)
    cache["v"].copy_(v)
    return cache


def cross_attention_prefill(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                            media: torch.Tensor, cache: Dict
                            ) -> Tuple[torch.Tensor, Dict]:
    """:func:`cross_attention_full_seq` that also fills the cross cache,
    projecting the media once where the reference projects it twice."""
    cache = prefill_cross_cache(cfg, p, media, cache)
    return _attend_media(cfg, p, x, cache["k"], cache["v"]), cache


def cross_attention_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                           cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: x (B,1,D) reads the prefilled media cache."""
    return _attend_media(cfg, p, x, cache["k"], cache["v"]), cache
