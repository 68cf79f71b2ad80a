"""Predictor architectures of the dual-predictor routing framework.

One predictor estimates the response *quality* of every pool member for a
query, a second of the same family its *cost*. This port carries the
paper's head, ``attn``: single-head cross-attention with the query
embedding as query and the model embeddings as keys and values. The
reference's other eight kinds wait in ROADMAP.md's Queue 1 (item 2).

Functional, as in ``repro.core.predictors``: ``init(gen, dq, k, dm) ->
params`` makes the params on ``gen``'s device; ``apply(params, q, m) ->
(B, K)`` for ``q`` (B, dq) and model embeddings ``m`` (K, dm).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.models.layers import dense_init


class PredictorDef(NamedTuple):
    init: Callable          # (gen, d_query, n_models, d_model_emb) -> params
    apply: Callable         # (params, q (B,dq), m (K,dm)) -> (B,K)
    pool_free: bool         # True if params are independent of K


ATTN_LATENT = 20  # internal dimension (paper §5: cost predictor maps to 20)


def _init_attn(gen: torch.Generator, dq: int, k: int, dm: int,
               latent: int = ATTN_LATENT) -> Dict:
    return {
        "wq": dense_init(gen, dq, latent),
        "wk": dense_init(gen, dm, latent),
        "wv": dense_init(gen, dm, latent),
        "wo": dense_init(gen, latent, k),
        "bo": torch.zeros((k,), dtype=torch.float32, device=gen.device),
    }


def attention_scores(p: Dict, q: torch.Tensor, m: torch.Tensor):
    """Core single-head cross-attention (paper Fig. 2).

    Returns the attended context (B, latent) and the weights (B, K). The
    logit scale is 1/sqrt(d_v), d_v the unpadded latent.
    """
    qp = q @ p["wq"]                                   # (B, d)
    kp = m @ p["wk"]                                   # (K, d)
    vp = m @ p["wv"]                                   # (K, d)
    logits = (qp @ kp.T) / math.sqrt(vp.shape[-1])     # (B, K)
    alpha = torch.softmax(logits, dim=-1)
    return alpha @ vp, alpha


def _apply_attn(p: Dict, q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    ctx, _ = attention_scores(p, q, m)
    return ctx @ p["wo"] + p["bo"]


PREDICTORS: Dict[str, PredictorDef] = {
    "attn": PredictorDef(_init_attn, _apply_attn, pool_free=False),
}
