"""Decoder LM over a layer plan of self-attention, cross-attention, Mamba,
mLSTM and sLSTM blocks, each with a SwiGLU MLP, an MoE FFN or none.

The port of ``repro.models.lm`` for all ten of the reference's configs:
its default serve pool (qwen3-0.6b, granite-3-8b and the
mixture-of-experts granite-moe), qwen1.5-4b (QKV bias), gemma3-27b (5:1
local:global, sliding-window locals on a ring cache), xlstm-1.3b (sLSTM
and mLSTM blocks without an FFN), the jamba hybrid (Mamba and attention,
MLP and MoE), musicgen-large, llama4-maverick (MLP and MoE layers in
turn, top-1 with a shared expert) and llama-3.2-vision (four
self-attention layers, then one cross-attention layer). The reference stacks the repeated ``pattern``'s
parameters on a leading ``n_repeats`` axis, with the ``remainder`` apart,
and scans over it; here the plan is a plain loop over
``params["layers"]``, one parameter dict per layer in
:meth:`ArchConfig.layer_plan` order (:mod:`repro_torch.bridge` unstacks
the reference's tree into this layout). Each layer's decode cache is made
for its spec: a ring of ``min(window, max_len)`` slots for a windowed
attention layer, a linear KV cache for another attention layer, one slot
per media token for a cross-attention layer, the recurrent state for a
Mamba, mLSTM or sLSTM layer.

Media: a config with cross-attention (XATTN) layers prefills with
``media`` (B, n_frontend_tokens, frontend_dim), the stub encoder's
output; without it :func:`apply_lm_prefill` raises ``ValueError``, where
the reference fails on ``None @ w_proj``. Other configs ignore ``media``.
It is keyword-only everywhere: the reference takes it before ``attn_mask``,
so a positional copy of a reference call fails at the signature.

Entry points:
  * train: full sequence -> token loss + MoE aux (:func:`lm_loss`, the
    loss in sequence chunks; each pattern repeat under
    ``torch.utils.checkpoint`` with ``remat``), or full logits + aux
    (:func:`apply_lm_train`)
  * prefill: full prompt -> last-position logits + decode caches (dense
    attention below 2048 tokens, banded flash attention from there; the
    chunkwise mLSTM, the sequential sLSTM and the chunked Mamba scan)
  * decode:  one token + caches -> logits (caches updated in place)
  * greedy_generate: prefill, then ``max_new - 1`` decode steps
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from repro_torch.common.tree import map_with_paths, tree_map
from repro_torch.configs.base import (
    ATTN, MAMBA, MLP, MLSTM, MOE, NONE, SLSTM, XATTN, ArchConfig, LayerSpec,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    apply_mlp, apply_rmsnorm, embed_tokens, init_embedding, init_mlp,
    init_rmsnorm, lm_logits, token_cross_entropy,
)
from repro_torch.models.sharding_ctx import gather_fsdp, shard

LOSS_SEQ_CHUNK = 512


class _Recurrent(NamedTuple):
    """A recurrent mixer's functions; its decode cache is its state."""
    init: Callable
    init_cache: Callable
    train: Callable
    prefill: Callable
    decode: Callable


_RECURRENT = {
    MAMBA: _Recurrent(ssm_mod.init_mamba, ssm_mod.init_mamba_cache,
                      ssm_mod.apply_mamba_train, ssm_mod.apply_mamba_prefill,
                      ssm_mod.apply_mamba_decode),
    MLSTM: _Recurrent(xlstm_mod.init_mlstm, xlstm_mod.init_mlstm_cache,
                      xlstm_mod.apply_mlstm_train, xlstm_mod.apply_mlstm_prefill,
                      xlstm_mod.apply_mlstm_decode),
    SLSTM: _Recurrent(xlstm_mod.init_slstm, xlstm_mod.init_slstm_cache,
                      xlstm_mod.apply_slstm_train, xlstm_mod.apply_slstm_prefill,
                      xlstm_mod.apply_slstm_decode),
}


_ATTENTION = (ATTN, XATTN)


def check_media(cfg: ArchConfig, media: Optional[torch.Tensor], batch: int) -> None:
    """Raise unless ``media`` is what ``cfg``'s cross-attention layers read:
    (batch, n_frontend_tokens, frontend_dim). A config without them takes
    any ``media``, as the reference does, and ignores it."""
    if not cfg.has_mixer(XATTN):
        return
    want = (batch, cfg.n_frontend_tokens, cfg.frontend_dim)
    if media is None or tuple(media.shape) != want:
        got = None if media is None else tuple(media.shape)
        raise ValueError(
            f"{cfg.name} has cross-attention (XATTN) layers: prefill needs media "
            f"of shape (B, n_frontend_tokens, frontend_dim) = {want}, got {got}; "
            "a served vlm member gets launch/serve.py::build_pool's seeded stub")


def prefill_width(cfg: ArchConfig, s: int) -> int:
    """The width a prompt batch of ``s`` tokens is left-padded to for
    ``cfg``'s layer plan: above ``MLSTM_CHUNK`` tokens a plan with mLSTM
    layers pads to a multiple of that chunk; a plan with attention then
    takes the flash rule (a multiple of ``FLASH_CHUNK`` from
    ``FLASH_MIN_SEQ``). Pads are masked keys or identity updates, so the
    extra width leaves every real row as it was."""
    if cfg.has_mixer(MLSTM):
        s = xlstm_mod.prefill_width(s)
    if cfg.has_mixer(ATTN):
        s = attn_mod.prefill_width(s)
    return s


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec) -> Dict:
    mixer = (attn_mod.init_attention(gen, cfg, spec) if spec.mixer in _ATTENTION
             else _RECURRENT[spec.mixer].init(gen, cfg))
    p = {"norm1": init_rmsnorm(cfg.d_model, gen.device), "mixer": mixer}
    if spec.ffn != NONE:
        p["norm2"] = init_rmsnorm(cfg.d_model, gen.device)
        p["ffn"] = (moe_mod.init_moe(gen, cfg) if spec.ffn == MOE
                    else init_mlp(gen, cfg.d_model, cfg.d_ff))
    return p


def init_block_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
                     device) -> Dict:
    if spec.mixer in _ATTENTION:
        return attn_mod.init_kv_cache(cfg, spec, batch, max_len, device)
    return _RECURRENT[spec.mixer].init_cache(cfg, batch, device)


def _apply_ffn_train(cfg: ArchConfig, spec: LayerSpec, p: Dict, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """(x + FFN(x), MoE aux loss; 0.0 without MoE). ``mask`` (B, S) bool
    marks real tokens of a left-padded batch; MoE leaves pads out of
    capacity and the aux loss. Prefill takes this FFN too and drops the
    aux."""
    if spec.ffn == NONE:
        return x, 0.0
    h = apply_rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == MLP:
        return x + apply_mlp(p["ffn"], h), 0.0
    y, aux = moe_mod.apply_moe_train(cfg, p["ffn"], h, mask=mask)
    return x + y, aux


def _apply_ffn_decode(cfg: ArchConfig, spec: LayerSpec, p: Dict,
                      x: torch.Tensor) -> torch.Tensor:
    if spec.ffn == NONE:
        return x
    h = apply_rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == MLP:
        return x + apply_mlp(p["ffn"], h)
    return x + moe_mod.apply_moe_decode(cfg, p["ffn"], h)


def apply_block_train(cfg, spec, p, x, positions, mask=None, *, media=None):
    """Full-sequence pass of one block: (x, MoE aux loss).

    ``mask`` (B, S) bool marks real tokens of a left-padded batch; every
    mixer family applies its masked-compute variant (pad keys masked,
    identity recurrence updates, pad-excluded MoE capacity).
    """
    p = gather_fsdp(p)
    h = apply_rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.mixer == ATTN:
        y = attn_mod.self_attention_full_seq(cfg, spec, p["mixer"], h, positions,
                                             kv_valid=mask)
    elif spec.mixer == XATTN:
        y = attn_mod.cross_attention_full_seq(cfg, p["mixer"], h, media)
    else:
        y = _RECURRENT[spec.mixer].train(cfg, p["mixer"], h, mask=mask)
    return _apply_ffn_train(cfg, spec, p, x + y, mask)


def apply_block_prefill(cfg, spec, p, x, positions, cache, attn_mask=None, *,
                        media=None):
    """Full-prompt pass that also fills this block's decode cache.

    ``attn_mask`` (B, S) bool marks real tokens of a left-padded batch:
    attention masks pad keys and records them invalid in the cache per
    row; the recurrent mixers make pad steps identity updates of their
    state, which is the decode cache. Cross attention reads ``media``
    unmasked: a pad query's output reaches no real token, since later
    layers mask pad keys.
    """
    p = gather_fsdp(p)
    h = apply_rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.mixer == ATTN:
        y, cache = attn_mod.self_attention_prefill(cfg, spec, p["mixer"], h,
                                                   positions, cache,
                                                   kv_valid=attn_mask)
    elif spec.mixer == XATTN:
        y, cache = attn_mod.cross_attention_prefill(cfg, p["mixer"], h, media, cache)
    else:
        y, state = _RECURRENT[spec.mixer].prefill(cfg, p["mixer"], h, mask=attn_mask)
        cache.update(state)
    return _apply_ffn_train(cfg, spec, p, x + y, attn_mask)[0], cache


def apply_block_decode(cfg, spec, p, x, pos: int, cache):
    p = gather_fsdp(p)
    h = apply_rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.mixer == ATTN:
        y, cache = attn_mod.self_attention_decode(cfg, spec, p["mixer"], h, cache, pos)
    elif spec.mixer == XATTN:
        y, cache = attn_mod.cross_attention_decode(cfg, p["mixer"], h, cache)
    else:
        y, cache = _RECURRENT[spec.mixer].decode(cfg, p["mixer"], h, cache)
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
    return {
        "embedding": init_embedding(gen, cfg.padded_vocab, cfg.d_model),
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
        "layers": [init_block(gen, cfg, spec) for spec in plan],
    }


class _ShapesOnly(TorchDispatchMode):
    """Runs an init as a shape computation on the meta device: every
    tensor it makes is made there, its random fills are skipped, and a
    data-dependent read (a rejection-sampling loop's ``any()``) sees 0."""

    _SKIP = (torch.ops.aten.uniform_, torch.ops.aten.normal_)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func._overloadpacket in self._SKIP:
            return args[0]
        if func is torch.ops.aten._local_scalar_dense.default:
            return False if args[0].dtype == torch.bool else 0
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)


def abstract_params(cfg: ArchConfig, dtype: torch.dtype = torch.float32) -> Dict:
    """Meta tensors shaped as :func:`init_lm`'s params, in ``dtype``:
    the dry-run's params, which allocate nothing."""
    with _ShapesOnly():
        params = init_lm(torch.Generator().manual_seed(0), cfg)
    return tree_map(lambda p: p.to(dtype), params)


def abstract_caches(cfg: ArchConfig, batch: int, max_len: int,
                    dtype: torch.dtype = torch.float32) -> List[Dict]:
    """Meta tensors shaped as :func:`init_caches`' caches, allocating
    nothing. As in the reference, the K/V and conv-window leaves take
    ``dtype`` and the recurrent states stay float32."""
    return map_with_paths(
        lambda path, c: c.to(dtype) if path.rsplit("/", 1)[-1] in _CACHE_CAST else c,
        init_caches(cfg, batch, max_len, "meta"))


_CACHE_CAST = ("k", "v", "conv")


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
    sliding-window layer, ``max_len`` linear slots for another attention
    layer, ``n_frontend_tokens`` slots for a cross-attention layer, the
    recurrent state for a Mamba, mLSTM or sLSTM layer."""
    return [init_block_cache(cfg, spec, batch, max_len, device)
            for spec in cfg.layer_plan()]


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    """Prefill positions ``arange(S)`` for every row (not per-row offsets)."""
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)


def _repeat_train(cfg: ArchConfig, specs, layers, x: torch.Tensor,
                  positions: torch.Tensor, media, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocks ``specs`` with params ``layers`` in turn: (x, summed aux)."""
    aux = x.new_zeros((), dtype=torch.float32)
    for spec, p in zip(specs, layers):
        x, a = apply_block_train(cfg, spec, p, x, positions, mask, media=media)
        aux = aux + a
    return x, aux


def _backbone_train(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                    positions: torch.Tensor, media, remat: bool = True,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer plan over (B,S,D) activations: (final-normed x, MoE aux).

    With ``remat`` each repeat of the pattern runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference's
    ``jax.checkpoint`` around its scan body: autograd keeps the activations
    only between repeats and recomputes a repeat's in its backward. The
    forward records autograd as the recompute does, so the Mamba scan takes
    the same path in both. The remainder layers run without it.
    """
    pat = tuple(cfg.pattern)
    n = len(pat)
    layers = params["layers"]
    aux = x.new_zeros((), dtype=torch.float32)
    for r in range(cfg.n_repeats):
        block = (cfg, pat, layers[r * n:(r + 1) * n], x, positions, media, mask)
        x, a = (checkpoint(_repeat_train, *block, use_reentrant=False) if remat
                else _repeat_train(*block))
        x = shard(x, "batch", "seq", "embed")
        aux = aux + a
    x, a = _repeat_train(cfg, cfg.remainder, layers[cfg.n_repeats * n:], x, positions,
                         media, mask)
    return apply_rmsnorm(params["final_norm"], x, cfg.norm_eps), aux + a


def apply_lm_train(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
                   media: Optional[torch.Tensor] = None, remat: bool = True,
                   attn_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full logits (B, S, padded_vocab) and the MoE aux loss (the small-vocab
    test path; :func:`lm_loss` never holds all the logits).

    ``attn_mask`` (B, S) bool marks real tokens of a left-padded batch
    (None = all real); masked compute applies in every mixer family.
    """
    check_media(cfg, media, tokens.shape[0])
    x = shard(embed_tokens(params["embedding"], tokens), "batch", "seq", "embed")
    x, aux = _backbone_train(cfg, params, x, _positions(tokens), media, remat,
                             mask=attn_mask)
    return lm_logits(params["embedding"], x), aux


def _chunk_loss(cfg: ArchConfig, head: torch.Tensor, xc: torch.Tensor, lc: torch.Tensor,
                mc: Optional[torch.Tensor]) -> torch.Tensor:
    """Summed token cross entropy of one sequence chunk."""
    tok_loss = token_cross_entropy(xc @ gather_fsdp(head), lc, cfg.vocab_size)
    if mc is not None:
        tok_loss = tok_loss * mc
    return tok_loss.sum()


def lm_loss(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, labels: torch.Tensor, *,
            media: Optional[torch.Tensor] = None, remat: bool = True,
            attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy + ``router_aux_coef`` · MoE aux.

    The loss is taken in chunks of ``LOSS_SEQ_CHUNK`` positions when S is a
    larger multiple of it, else in one; each chunk runs under
    ``torch.utils.checkpoint``, so the (B, S, padded_vocab) logits never
    exist at once and a chunk's are made again in the backward pass.
    ``attn_mask`` (B, S) bool marks real tokens of a left-padded batch:
    pads count in neither the numerator nor the denominator
    (``max(sum(mask), 1)``) and, through the backbone, not in the MoE
    capacity or aux.
    """
    check_media(cfg, media, tokens.shape[0])
    x = shard(embed_tokens(params["embedding"], tokens), "batch", "seq", "embed")
    x, aux = _backbone_train(cfg, params, x, _positions(tokens), media, remat,
                             mask=attn_mask)
    b, s, _ = x.shape
    head = params["embedding"]["head"]
    width = LOSS_SEQ_CHUNK if s > LOSS_SEQ_CHUNK and s % LOSS_SEQ_CHUNK == 0 else s
    total = sum(checkpoint(_chunk_loss, cfg, head, x[:, lo:lo + width],
                           labels[:, lo:lo + width],
                           None if attn_mask is None else attn_mask[:, lo:lo + width],
                           use_reentrant=False)
                for lo in range(0, s, width))
    denom = b * s if attn_mask is None else attn_mask.sum().clamp(min=1)
    return total / denom + cfg.router_aux_coef * aux


def apply_lm_prefill(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
                     caches: List[Dict], attn_mask: Optional[torch.Tensor] = None,
                     *, media: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, List[Dict]]:
    """Prefill: full forward + cache build. Returns (last logits (B,1,V), caches).

    ``attn_mask`` (B, S) bool marks real tokens of a left-padded batch
    (None = all real). ``media`` (B, n_frontend_tokens, frontend_dim) is
    what the cross-attention layers read (:func:`check_media`).
    """
    check_media(cfg, media, tokens.shape[0])
    x = shard(embed_tokens(params["embedding"], tokens), "batch", "seq", "embed")
    positions = _positions(tokens)
    n = len(cfg.pattern)
    for i, (spec, p, cache) in enumerate(zip(cfg.layer_plan(), params["layers"], caches)):
        x, _ = apply_block_prefill(cfg, spec, p, x, positions, cache,
                                   attn_mask=attn_mask, media=media)
        if i < cfg.n_repeats * n and i % n == n - 1:     # a pattern repeat's end
            x = shard(x, "batch", "seq", "embed")
    x_last = apply_rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return lm_logits(params["embedding"], x_last), caches


def apply_lm_decode(cfg: ArchConfig, params: Dict, token: torch.Tensor,
                    caches: List[Dict], pos: int
                    ) -> Tuple[torch.Tensor, List[Dict]]:
    """One decode step. token (B,1); ``pos`` the next position, one for the batch."""
    x = shard(embed_tokens(params["embedding"], token), "batch", "seq", "embed")
    for spec, p, cache in zip(cfg.layer_plan(), params["layers"], caches):
        x, _ = apply_block_decode(cfg, spec, p, x, pos, cache)
    x = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params["embedding"], x), caches


def greedy_generate(cfg: ArchConfig, params: Dict, prompt: torch.Tensor,
                    max_new: int, *,
                    attn_mask: Optional[torch.Tensor] = None,
                    media: Optional[torch.Tensor] = None,
                    prefill: Optional[Callable] = None,
                    decode: Optional[Callable] = None) -> torch.Tensor:
    """Greedy decoding: (B, S) prompt -> (B, max_new) int32 tokens.

    ``attn_mask`` (B, S) bool marks real prompt tokens of a left-padded
    batch, so each request's output is invariant to its batch neighbours.
    ``media`` feeds the cross-attention layers (:func:`apply_lm_prefill`).
    The argmax runs over ``vocab_size``, not the padded vocab, and takes
    the first maximum, as ``jnp.argmax`` does.

    ``prefill`` and ``decode`` stand in for :func:`apply_lm_prefill` and
    :func:`apply_lm_decode` (the same arguments after ``cfg``, logits
    returned as whole tensors): ``launch/steps.py::make_generate`` passes
    a mesh's steps, so that one loop serves both layouts. The loop runs
    under inference mode, or under ``no_grad`` with the steps given, as
    DTensor's dispatch refuses some of the model's ops in inference mode.
    """
    stepped = prefill is not None or decode is not None
    prefill = prefill or functools.partial(apply_lm_prefill, cfg)
    decode = decode or functools.partial(apply_lm_decode, cfg)
    with torch.no_grad() if stepped else torch.inference_mode():
        b, s = prompt.shape
        caches = init_caches(cfg, b, s + max_new, prompt.device)
        logits, caches = prefill(params, prompt, caches, attn_mask=attn_mask, media=media)
        tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None]
        out = [tok]
        for i in range(max_new - 1):
            logits, caches = decode(params, tok, caches, s + i)
            tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32)
