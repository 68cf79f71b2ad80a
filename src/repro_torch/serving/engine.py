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
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.rewards import REWARDS
from repro_torch.core.router import PredictiveRouter
from repro_torch.data.featurizer import embed_texts
from repro_torch.kernels import ops as kops
from repro_torch.models import lm as lm_mod

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
    name: str
    cfg: object
    params: Dict
    cost_rate: float

    @property
    def device(self) -> torch.device:
        return self.params["embedding"]["table"].device

    def generate(self, prompts: torch.Tensor, max_new: int = 8,
                 attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        mask = None if attn_mask is None else attn_mask.to(self.device)
        return lm_mod.greedy_generate(self.cfg, self.params,
                                      prompts.to(self.device), max_new,
                                      attn_mask=mask)


def pad_prompts(prompts: Sequence[np.ndarray], pad_id: int = 0) -> torch.Tensor:
    """Left-pad variable-length token rows into one (B, S_max) int32 batch.

    Left padding keeps the last prompt position real, which the greedy
    prefill conditions the first generated token on. Pass the matching
    :func:`prompt_pad_mask` into generate so pad keys are masked and each
    request's output is invariant to its micro-batch neighbours.
    """
    s_max = max(int(len(p)) for p in prompts)
    out = np.full((len(prompts), s_max), pad_id, np.int32)
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32)
        out[i, s_max - len(p):] = p
    return torch.from_numpy(out)


def prompt_pad_mask(prompts: Sequence[np.ndarray]) -> torch.Tensor:
    """(B, S_max) bool, True at real (right-aligned) token positions."""
    s_max = max(int(len(p)) for p in prompts)
    mask = np.zeros((len(prompts), s_max), bool)
    for i, p in enumerate(prompts):
        mask[i, s_max - len(p):] = True
    return torch.from_numpy(mask)


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

    @torch.inference_mode()
    def _scores(self, q_emb: np.ndarray):
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
        return embed_texts(texts)

    def score_emb(self, q_emb: np.ndarray):
        """(s_hat, c_hat), both (B, K) numpy, from precomputed embeddings."""
        return self._scores(q_emb)

    def score_texts(self, texts: Sequence[str]):
        """(s_hat, c_hat), both (B, K) numpy — one fused pass over the batch."""
        return self._scores(embed_texts(texts))

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

    def choose(self, s_hat: np.ndarray, c_hat: np.ndarray,
               lam: Optional[float] = None) -> np.ndarray:
        """Reward argmax over the pool at willingness-to-pay ``lam``."""
        lam = self.lam if lam is None else lam
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
        batch. Returns ``(per-request output tokens, per-request $ costs)``.
        The charge is delivered work: prompt tokens plus the new tokens
        each request receives (capped by its ``max_new_per_req`` entry when
        given), at the member's per-token rate.
        """
        member = self.pool[member_idx]
        toks = member.generate(pad_prompts(prompts), max_new=max_new,
                               attn_mask=prompt_pad_mask(prompts)).cpu().numpy()
        outs = [toks[i] for i in range(len(prompts))]
        per_tok = member.cost_rate / REF_TOKENS_OUT
        caps = (max_new_per_req if max_new_per_req is not None
                else [max_new] * len(prompts))
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
