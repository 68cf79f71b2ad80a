"""Decoder LM over a layer plan of attention blocks with a SwiGLU MLP or an
MoE FFN.

The port of ``repro.models.lm`` for its attention members: the reference's
default serve pool (qwen3-0.6b, granite-3-8b and the mixture-of-experts
granite-moe), qwen1.5-4b (QKV bias) and gemma3-27b (5:1 local:global,
sliding-window locals on a ring cache). The reference stacks the repeated
``pattern``'s parameters on a leading ``n_repeats`` axis, with the
``remainder`` apart, and scans over it; here the plan is a plain loop over
``params["layers"]``, one parameter dict per layer in
:meth:`ArchConfig.layer_plan` order (:mod:`repro_torch.bridge` unstacks
the reference's tree into this layout). Each layer's decode cache is made
for its spec: a ring of ``min(window, max_len)`` slots for a windowed
layer, a linear cache otherwise.

Entry points:
  * prefill: full prompt -> last-position logits + decode caches (dense
    attention below 2048 tokens, banded flash attention from there)
  * decode:  one token + caches -> logits (caches updated in place)
  * greedy_generate: prefill, then ``max_new - 1`` decode steps
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, MLP, MOE, ArchConfig, LayerSpec
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    apply_mlp, apply_rmsnorm, embed_tokens, init_embedding, init_mlp,
    init_rmsnorm, lm_logits,
)


def _check_block(spec: LayerSpec) -> None:
    if spec.mixer != ATTN or spec.ffn not in (MLP, MOE):
        raise NotImplementedError(
            f"block {spec.mixer}+{spec.ffn} is not ported yet; the port runs "
            "attention blocks with an MLP or MoE FFN (ROADMAP.md Queue 1, item 6)")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec) -> Dict:
    _check_block(spec)
    return {
        "norm1": init_rmsnorm(cfg.d_model, gen.device),
        "mixer": attn_mod.init_attention(gen, cfg, spec),
        "norm2": init_rmsnorm(cfg.d_model, gen.device),
        "ffn": (moe_mod.init_moe(gen, cfg) if spec.ffn == MOE
                else init_mlp(gen, cfg.d_model, cfg.d_ff)),
    }


def _apply_ffn_prefill(cfg: ArchConfig, spec: LayerSpec, p: Dict, x: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Prefill takes the reference's train-path FFN: capacity-grouped MoE
    with pads left out of capacity (``mask``); the aux loss is dropped."""
    h = apply_rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == MLP:
        return x + apply_mlp(p["ffn"], h)
    return x + moe_mod.apply_moe_train(cfg, p["ffn"], h, mask=mask)[0]


def _apply_ffn_decode(cfg: ArchConfig, spec: LayerSpec, p: Dict,
                      x: torch.Tensor) -> torch.Tensor:
    h = apply_rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == MLP:
        return x + apply_mlp(p["ffn"], h)
    return x + moe_mod.apply_moe_decode(cfg, p["ffn"], h)


def apply_block_prefill(cfg, spec, p, x, positions, cache, attn_mask=None):
    """Full-prompt pass that also fills this block's decode cache.

    ``attn_mask`` (B, S) bool marks real tokens of a left-padded batch:
    pad keys are masked and recorded invalid in the cache per row.
    """
    h = apply_rmsnorm(p["norm1"], x, cfg.norm_eps)
    y, cache = attn_mod.self_attention_prefill(cfg, spec, p["mixer"], h,
                                               positions, cache,
                                               kv_valid=attn_mask)
    return _apply_ffn_prefill(cfg, spec, p, x + y, attn_mask), cache


def apply_block_decode(cfg, spec, p, x, pos: int, cache):
    h = apply_rmsnorm(p["norm1"], x, cfg.norm_eps)
    y, cache = attn_mod.self_attention_decode(cfg, spec, p["mixer"], h, cache, pos)
    return _apply_ffn_decode(cfg, spec, p, x + y), cache


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ArchConfig) -> Dict:
    """Seeded fp32 parameters, made on ``gen``'s device.

    Same distributions as the reference (truncated-normal fan-in weights,
    N(0, 0.02) embedding table, unit norm scales); the numbers differ,
    since torch's and JAX's generators do.
    """
    plan = cfg.layer_plan()
    for spec in plan:
        _check_block(spec)
    return {
        "embedding": init_embedding(gen, cfg.padded_vocab, cfg.d_model),
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
        "layers": [init_block(gen, cfg, spec) for spec in plan],
    }


def seed_qkv_biases(params: Dict, cfg: ArchConfig, seed: int = 7) -> Dict:
    """Give every QKV bias of ``params`` seeded nonzero values, in place.

    :func:`init_lm` starts the biases at zero, as the reference does, so a
    check of the bias path seeds them first. Returns ``params``.
    """
    if cfg.qkv_bias:
        gen = torch.Generator(device=params["embedding"]["table"].device).manual_seed(seed)
        for layer in params["layers"]:
            for key in ("bq", "bk", "bv"):
                b = layer["mixer"][key]
                b.copy_(torch.randn(b.shape, generator=gen, device=b.device) * 0.5)
    return params


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device) -> List[Dict]:
    """One decode cache per layer, in layer-plan order: a ring for a
    sliding-window layer, ``max_len`` linear slots otherwise."""
    return [attn_mod.init_kv_cache(cfg, spec, batch, max_len, device)
            for spec in cfg.layer_plan()]


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    """Prefill positions ``arange(S)`` for every row (not per-row offsets)."""
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)


def apply_lm_prefill(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
                     caches: List[Dict], attn_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, List[Dict]]:
    """Prefill: full forward + cache build. Returns (last logits (B,1,V), caches).

    ``attn_mask`` (B, S) bool marks real tokens of a left-padded batch
    (None = all real).
    """
    x = embed_tokens(params["embedding"], tokens)
    positions = _positions(tokens)
    for spec, p, cache in zip(cfg.layer_plan(), params["layers"], caches):
        x, _ = apply_block_prefill(cfg, spec, p, x, positions, cache,
                                   attn_mask=attn_mask)
    x_last = apply_rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return lm_logits(params["embedding"], x_last), caches


def apply_lm_decode(cfg: ArchConfig, params: Dict, token: torch.Tensor,
                    caches: List[Dict], pos: int
                    ) -> Tuple[torch.Tensor, List[Dict]]:
    """One decode step. token (B,1); ``pos`` the next position, one for the batch."""
    x = embed_tokens(params["embedding"], token)
    for spec, p, cache in zip(cfg.layer_plan(), params["layers"], caches):
        x, _ = apply_block_decode(cfg, spec, p, x, pos, cache)
    x = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params["embedding"], x), caches


@torch.inference_mode()
def greedy_generate(cfg: ArchConfig, params: Dict, prompt: torch.Tensor,
                    max_new: int,
                    attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy decoding: (B, S) prompt -> (B, max_new) int32 tokens.

    ``attn_mask`` (B, S) bool marks real prompt tokens of a left-padded
    batch, so each request's output is invariant to its batch neighbours.
    The argmax runs over ``vocab_size``, not the padded vocab, and takes
    the first maximum, as ``jnp.argmax`` does.
    """
    b, s = prompt.shape
    caches = init_caches(cfg, b, s + max_new, prompt.device)
    logits, caches = apply_lm_prefill(cfg, params, prompt, caches,
                                      attn_mask=attn_mask)
    tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None]
    out = [tok]
    for i in range(max_new - 1):
        logits, caches = apply_lm_decode(cfg, params, tok, caches, s + i)
        tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).to(torch.int32)
