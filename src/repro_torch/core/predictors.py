"""Predictor architectures of the dual-predictor routing framework.

One predictor estimates the response *quality* of every pool member for a
query, a second of the same family its *cost*. The nine kinds of
``repro.core.predictors`` (paper §3 and Appendix C):

  reg        linear map   q_emb -> K scores
  2fcn/3fcn  MLPs         q_emb -> K scores (params shared across models)
  reg-emb / 2fcn-emb / 3fcn-emb
             per-model input concat [q_emb ; m_emb_k] -> 1 score
  attn       single-head cross-attention: q_emb as query, model embeddings
             as keys and values (the paper's head)
  attn-dot   the attention core with a pool-size-free scoring head
  attn-ens   the attention core with H output heads on a shared trunk;
             ``apply`` returns their mean, :data:`ENSEMBLE_KINDS` the
             per-head (H, B, K) scores whose spread is the epistemic
             uncertainty

Functional, as in the reference: ``init(gen, dq, k, dm) -> params`` makes
the params on ``gen``'s device; ``apply(params, q, m) -> (B, K)`` for ``q``
(B, dq) and model embeddings ``m`` (K, dm). Weights keep the reference's
``(d_in, d_out)`` layout; scalar leaves are 0-d tensors.
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


def _zeros(gen: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=gen.device)


def _pairs(q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(B, K, dq + dm): every query row beside every model embedding."""
    b, k = q.shape[0], m.shape[0]
    return torch.cat([q[:, None, :].expand(b, k, q.shape[1]),
                      m[None, :, :].expand(b, k, m.shape[1])], dim=-1)


# ---------------------------------------------------------------------------
# Regression
# ---------------------------------------------------------------------------

def _init_reg(gen, dq, k, dm):
    return {"w": dense_init(gen, dq, k), "b": _zeros(gen, k)}


def _apply_reg(p, q, m):
    return q @ p["w"] + p["b"]


def _init_reg_emb(gen, dq, k, dm):
    return {"w": dense_init(gen, dq + dm, 1), "b": _zeros(gen)}


def _apply_reg_emb(p, q, m):
    return (_pairs(q, m) @ p["w"])[..., 0] + p["b"]


# ---------------------------------------------------------------------------
# MLPs (2-layer and 3-layer FCNs)
# ---------------------------------------------------------------------------

MLP_HIDDEN = 256


def _init_fcn(gen, d_in, d_out, n_hidden):
    dims = [d_in] + [MLP_HIDDEN] * n_hidden + [d_out]
    return {f"layer{i}": {"w": dense_init(gen, dims[i], dims[i + 1]),
                          "b": _zeros(gen, dims[i + 1])}
            for i in range(len(dims) - 1)}


def _apply_fcn(p, x):
    n = len(p)
    for i in range(n):
        x = x @ p[f"layer{i}"]["w"] + p[f"layer{i}"]["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def _make_fcn(n_hidden):
    def init(gen, dq, k, dm):
        return _init_fcn(gen, dq, k, n_hidden)

    def apply(p, q, m):
        return _apply_fcn(p, q)

    return init, apply


def _make_fcn_emb(n_hidden):
    def init(gen, dq, k, dm):
        return _init_fcn(gen, dq + dm, 1, n_hidden)

    def apply(p, q, m):
        return _apply_fcn(p, _pairs(q, m))[..., 0]

    return init, apply


# ---------------------------------------------------------------------------
# Single-head cross-attention (the paper's router head)
# ---------------------------------------------------------------------------

ATTN_LATENT = 20  # internal dimension (paper §5: cost predictor maps to 20)


def _init_attn(gen, dq, k, dm, latent=ATTN_LATENT):
    return {
        "wq": dense_init(gen, dq, latent),
        "wk": dense_init(gen, dm, latent),
        "wv": dense_init(gen, dm, latent),
        "wo": dense_init(gen, latent, k),
        "bo": _zeros(gen, k),
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


def _apply_attn(p, q, m):
    ctx, _ = attention_scores(p, q, m)
    return ctx @ p["wo"] + p["bo"]


def _init_attn_dot(gen, dq, k, dm, latent=ATTN_LATENT):
    return {
        "wq": dense_init(gen, dq, latent),
        "wk": dense_init(gen, dm, latent),
        "wv": dense_init(gen, dm, latent),
        "scale": torch.ones((), dtype=torch.float32, device=gen.device),
        "bias": _zeros(gen),
    }


def _apply_attn_dot(p, q, m):
    """Pool-size-free head: score_m = (ctx + q~) . v~_m (dynamic pools)."""
    ctx, _ = attention_scores(p, q, m)
    return p["scale"] * ((ctx + q @ p["wq"]) @ (m @ p["wv"]).T) + p["bias"]


# ---------------------------------------------------------------------------
# Deep-ensemble cross-attention (shared trunk, H cheap output heads)
# ---------------------------------------------------------------------------

ENSEMBLE_HEADS = 4  # H: output heads sharing one cross-attention trunk


def _init_attn_ens(gen, dq, k, dm, latent=ATTN_LATENT, n_heads=ENSEMBLE_HEADS):
    return {
        "wq": dense_init(gen, dq, latent),
        "wk": dense_init(gen, dm, latent),
        "wv": dense_init(gen, dm, latent),
        # Per-head output maps on a leading head axis: (H, d, K).
        "wo": torch.stack([dense_init(gen, latent, k) for _ in range(n_heads)]),
        "bo": _zeros(gen, n_heads, k),
    }


def _apply_attn_ens_heads(p, q, m):
    """Per-head scores (H, B, K): the ensemble's full predictive spread."""
    ctx, _ = attention_scores(p, q, m)
    return torch.einsum("bd,hdk->hbk", ctx, p["wo"]) + p["bo"][:, None, :]


def _apply_attn_ens(p, q, m):
    return _apply_attn_ens_heads(p, q, m).mean(dim=0)


# kind -> heads-apply ``(params, q, m) -> (H, B, K)``, for the scoring paths
# that need the per-head spread (PredictiveRouter.predict_with_uncertainty).
ENSEMBLE_KINDS: Dict[str, Callable] = {
    "attn-ens": _apply_attn_ens_heads,
}


_fcn2_init, _fcn2_apply = _make_fcn(1)
_fcn3_init, _fcn3_apply = _make_fcn(2)
_fcn2e_init, _fcn2e_apply = _make_fcn_emb(1)
_fcn3e_init, _fcn3e_apply = _make_fcn_emb(2)

PREDICTORS: Dict[str, PredictorDef] = {
    "reg": PredictorDef(_init_reg, _apply_reg, pool_free=False),
    "2fcn": PredictorDef(_fcn2_init, _fcn2_apply, pool_free=False),
    "3fcn": PredictorDef(_fcn3_init, _fcn3_apply, pool_free=False),
    "reg-emb": PredictorDef(_init_reg_emb, _apply_reg_emb, pool_free=True),
    "2fcn-emb": PredictorDef(_fcn2e_init, _fcn2e_apply, pool_free=True),
    "3fcn-emb": PredictorDef(_fcn3e_init, _fcn3e_apply, pool_free=True),
    "attn": PredictorDef(_init_attn, _apply_attn, pool_free=False),
    "attn-dot": PredictorDef(_init_attn_dot, _apply_attn_dot, pool_free=True),
    "attn-ens": PredictorDef(_init_attn_ens, _apply_attn_ens, pool_free=False),
}
