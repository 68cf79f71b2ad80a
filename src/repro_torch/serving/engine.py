"""Routed serving engine: the paper's router fronting the architecture pool.

Flow per score batch:
    text -> featurizer -> dual predictors (quality, cost) -> R2 argmax
         -> the chosen pool member's greedy generate loop.

The port of ``repro.serving.engine``. Quality scores go through the
``router_xattn`` Hopper kernel (``use_kernel``, the counterpart of the
reference's ``use_pallas``) when the quality predictor is the attention
kind, with the pool-side K~/V~ projections computed once per pool; cost
always goes through the plain predictor. Each member's $ rate derives
from its active parameter count: 2*N_active FLOPs/token at a fixed $/FLOP.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.rewards import REWARDS
from repro_torch.core.router import PredictiveRouter
from repro_torch.data.featurizer import embed_texts
from repro_torch.kernels import ops as kops
from repro_torch.models import lm as lm_mod
from repro_torch.models import trace_hook

# $ per 1e12 FLOPs — anchors active-param FLOPs to an API-like price axis.
DOLLARS_PER_TFLOP = 2.2e-4

# Nominal generation length the per-request $ rate is quoted at; the ledger
# charges per delivered token, ``cost_rate / REF_TOKENS_OUT`` $ each.
REF_TOKENS_OUT = 256


def arch_cost_per_token(cfg) -> float:
    """$ per token processed: 2 * N_active FLOPs/token * $/FLOP."""
    return 2.0 * cfg.active_param_count() / 1e12 * DOLLARS_PER_TFLOP


def arch_cost_rate(cfg, tokens_out: int = REF_TOKENS_OUT) -> float:
    """Nominal $ per request at the reference generation length."""
    return arch_cost_per_token(cfg) * tokens_out


@dataclasses.dataclass
class PoolMember:
    """One member of the pool. ``media`` (1, n_frontend_tokens,
    frontend_dim) is a member's stub media, given to every request it
    serves, for a config with cross-attention layers (``build_pool``
    makes it); None otherwise. ``mesh`` is the ``DeviceMesh`` the params
    and media lie on as DTensors, once
    ``distributed/shard.py::shard_pool(..., mesh=...)`` has laid them out;
    None for whole tensors on one device."""

    name: str
    cfg: object
    params: Dict
    cost_rate: float
    media: Optional[torch.Tensor] = None
    mesh: Optional[object] = None
    # The greedy loop bound to the member's layout
    # (``launch/steps.py::make_generate``), set by ``shard_pool``; None runs
    # ``lm.greedy_generate`` on the member's device.
    greedy: Optional[Callable] = dataclasses.field(default=None, repr=False,
                                                   compare=False)

    @property
    def device(self) -> torch.device:
        """The device of the member's params (of this rank's shards on a
        mesh)."""
        table = self.params["embedding"]["table"]
        return table.to_local().device if self.mesh is not None else table.device

    def batch_media(self, batch: int) -> Optional[torch.Tensor]:
        """The stub media expanded over ``batch`` rows (a view), or None."""
        return None if self.media is None else self.media.expand(batch, -1, -1)

    def generate(self, prompts: torch.Tensor, max_new: int = 8,
                 attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy tokens (B, max_new) int32 for the left-padded ``prompts``
        (B, S), whole on the member's device."""
        greedy = self.greedy or functools.partial(lm_mod.greedy_generate, self.cfg)
        mask = None if attn_mask is None else attn_mask.to(self.device)
        return greedy(self.params, prompts.to(self.device), max_new, attn_mask=mask,
                      media=self.batch_media(prompts.shape[0]))


def _batch_width(prompts: Sequence[np.ndarray], cfg) -> int:
    return lm_mod.prefill_width(cfg, max(int(len(p)) for p in prompts))


def pad_prompts(prompts: Sequence[np.ndarray], cfg, pad_id: int = 0) -> torch.Tensor:
    """Left-pad variable-length token rows into one (B, S) int32 batch.

    Left padding keeps the last prompt position real, which the greedy
    prefill conditions the first generated token on. Pass the matching
    :func:`prompt_pad_mask` into generate so pads are masked and each
    request's output is invariant to its micro-batch neighbours. S is the
    longest prompt, rounded up to the length rules of ``cfg``'s layer plan
    (:func:`lm.prefill_width`: a multiple of the mLSTM chunk above it, of
    the flash chunk from ``FLASH_MIN_SEQ`` tokens).
    """
    s_max = _batch_width(prompts, cfg)
    out = np.full((len(prompts), s_max), pad_id, np.int32)
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32)
        out[i, s_max - len(p):] = p
    return torch.from_numpy(out)


def prompt_pad_mask(prompts: Sequence[np.ndarray], cfg) -> torch.Tensor:
    """(B, S) bool, True at real (right-aligned) token positions; S as
    :func:`pad_prompts` gives it for the same ``cfg``."""
    s_max = _batch_width(prompts, cfg)
    mask = np.zeros((len(prompts), s_max), bool)
    for i, p in enumerate(prompts):
        mask[i, s_max - len(p):] = True
    return torch.from_numpy(mask)


def _featurize(texts: Sequence[str]) -> np.ndarray:
    ht = trace_hook.TRACER
    if ht is None:
        return embed_texts(texts)
    return ht.call("featurize", embed_texts, texts, n=len(texts))


@dataclasses.dataclass
class RoutedEngine:
    """Stateless scoring/dispatch core: the router and the model pool.

    ``device`` is where scoring runs: the CUDA card unless the caller
    names another; the router's params must live there.
    """

    router: PredictiveRouter
    pool: List[PoolMember]
    lam: float = 1.0
    use_kernel: bool = True
    device: Optional[DeviceLike] = None
    # Observability hook: called with the new router version after every
    # successful swap (the scheduler wires it to its tracer).
    on_swap: Optional[Callable[[int], None]] = dataclasses.field(
        default=None, repr=False)
    _pool_proj: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # -- scoring ------------------------------------------------------------

    def pool_projections(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cached pool-side K~/V~ for the fused scoring path (once per pool)."""
        if self._pool_proj is None:
            qp = self.router.quality_params
            self._pool_proj = kops.pool_projections(
                qp["wk"], qp["wv"], self.router.model_emb_tensor())
        return self._pool_proj

    def refresh_pool(self) -> None:
        """Invalidate cached projections after the pool/router changes."""
        self._pool_proj = None

    def _scores(self, q_emb: np.ndarray):
        ht = trace_hook.TRACER
        if ht is None:
            return self._score_pass(q_emb)
        return ht.call("score", self._score_pass, q_emb, n=len(q_emb))

    @torch.inference_mode()
    def _score_pass(self, q_emb: np.ndarray):
        if not (self.use_kernel and self.router.quality_kind == "attn"):
            return self.router.predict(q_emb)
        qp = self.router.quality_params
        kt, vt = self.pool_projections()
        # No bucketing of B: the reference padded it to a multiple of 64 so
        # jit would not recompile per batch size; the kernel takes any B.
        q = torch.as_tensor(np.asarray(q_emb, np.float32), device=self.device)
        s_hat = kops.router_xattn_pool(q, qp["wq"], kt, vt, qp["wo"], qp["bo"])
        c_hat = PREDICTORS[self.router.cost_kind].apply(
            self.router.cost_params, q, self.router.model_emb_tensor())
        return (s_hat.cpu().numpy(),
                self.router.denormalize_cost(c_hat.cpu().numpy()))

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Query embeddings (B, 768) numpy, float64 as the featurizer gives
        them; scoring narrows them to float32."""
        return _featurize(texts)

    def score_emb(self, q_emb: np.ndarray):
        """(s_hat, c_hat), both (B, K) numpy, from precomputed embeddings."""
        return self._scores(q_emb)

    def score_emb_uncertainty(self, q_emb: np.ndarray):
        """(s_mean, s_std, c_hat), each (B, K) numpy: the cascade's scoring.

        Ensemble quality kinds report the heads' spread as epistemic std;
        other kinds report zero std. This path runs the plain predictors
        (``router.predict_with_uncertainty``), as the reference's does: the
        ``router_xattn`` kernel computes one output head, and the heads'
        spread is exactly what fusing them would take away.
        """
        return self.router.predict_with_uncertainty(q_emb)

    def score_texts(self, texts: Sequence[str]):
        """(s_hat, c_hat), both (B, K) numpy — one fused pass over the batch."""
        return self._scores(_featurize(texts))

    # -- router swaps -------------------------------------------------------

    def swap_router(self, new_router: PredictiveRouter) -> None:
        """Publish a new router version; stale versions are rejected so a
        slow updater cannot roll back a newer router."""
        if new_router is self.router:
            raise ValueError("swap_router needs a new router object "
                             "(routers are immutable; use with_updates)")
        if new_router.version <= self.router.version:
            raise ValueError(
                f"stale router publish: v{new_router.version} <= "
                f"live v{self.router.version}")
        self.router = new_router
        self.refresh_pool()
        if self.on_swap is not None:
            self.on_swap(new_router.version)

    def choose(self, s_hat: np.ndarray, c_hat: np.ndarray,
               lam: Optional[float] = None) -> np.ndarray:
        """Reward argmax over the pool at willingness-to-pay ``lam``."""
        lam = self.lam if lam is None else lam
        ht = trace_hook.TRACER
        if ht is None:
            return self._choose(s_hat, c_hat, lam)
        return ht.call("choose", self._choose, s_hat, c_hat, lam, n=len(s_hat))

    def _choose(self, s_hat, c_hat, lam: float) -> np.ndarray:
        r = REWARDS[self.router.reward](torch.from_numpy(np.asarray(s_hat)),
                                        torch.from_numpy(np.asarray(c_hat)), lam)
        return np.argmax(r.numpy(), axis=-1)

    def route_texts(self, texts: Sequence[str],
                    lam: Optional[float] = None) -> np.ndarray:
        s_hat, c_hat = self.score_texts(texts)
        return self.choose(s_hat, c_hat, lam)

    # -- dispatch -----------------------------------------------------------

    def generate_member(self, member_idx: int, prompts: Sequence[np.ndarray],
                        max_new: int = 8,
                        max_new_per_req: Optional[Sequence[int]] = None,
                        ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Run one generate micro-batch on a pool member.

        ``prompts`` are variable-length token rows, left-padded into one
        batch to the member's length rules. Returns ``(per-request output
        tokens, per-request $ costs)``.
        The charge is delivered work: prompt tokens plus the new tokens
        each request receives (capped by its ``max_new_per_req`` entry when
        given), at the member's per-token rate.
        """
        member = self.pool[member_idx]
        caps = (max_new_per_req if max_new_per_req is not None
                else [max_new] * len(prompts))
        ht = trace_hook.TRACER
        t0 = ht.now() if ht is not None else 0.0
        padded, mask = pad_prompts(prompts, member.cfg), prompt_pad_mask(prompts, member.cfg)
        if ht is not None:
            ht.span("pad", t0)
        out = member.generate(padded, max_new=max_new, attn_mask=mask)
        t = ht.now() if ht is not None else 0.0
        toks = out.cpu().numpy()
        if ht is not None:
            ht.span("to_host", t)
            ht.generate(member.name, t0, [len(p) for p in prompts], caps, max_new,
                        padded.shape[1])
        outs = [toks[i] for i in range(len(prompts))]
        per_tok = member.cost_rate / REF_TOKENS_OUT
        costs = np.asarray(
            [per_tok * (len(np.asarray(p)) + min(len(o), int(cap)))
             for p, o, cap in zip(prompts, outs, caps)], np.float64)
        return outs, costs

    def serve(self, texts: Sequence[str], prompts: Sequence[np.ndarray],
              max_new: int = 8) -> Dict:
        """One-shot batch serving (no queue): route, then generate.

        Requests routed to the same member are coalesced into one generate
        call.
        """
        t0 = time.time()
        choices = self.route_texts(texts)
        out_tokens = [None] * len(texts)
        total_cost = 0.0
        for mi in range(len(self.pool)):
            idx = np.flatnonzero(choices == mi)
            if len(idx) == 0:
                continue
            outs, cost = self.generate_member(
                mi, [np.asarray(prompts[i]) for i in idx], max_new=max_new)
            for j, ii in enumerate(idx):
                out_tokens[ii] = outs[j]
            total_cost += float(np.sum(cost))
        return {
            "choices": choices,
            "outputs": out_tokens,
            "total_cost": total_cost,
            "latency_s": time.time() - t0,
            "per_member_counts": np.bincount(choices, minlength=len(self.pool)),
        }
