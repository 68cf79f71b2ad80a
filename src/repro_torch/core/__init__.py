"""The paper's contribution: cost-aware cross-attention LLM routing."""
from repro_torch.core.predictors import ENSEMBLE_KINDS, PREDICTORS, attention_scores
from repro_torch.core.rewards import (
    REWARDS,
    cascade_outcome,
    cascade_reward,
    reward_exponential,
    reward_linear,
    route,
)
from repro_torch.core.metrics import (
    DEFAULT_LAMBDA_GRID,
    aiq,
    evaluate_router,
    frontier_dominance,
    frontier_value_at,
    lam_sensitivity,
    max_calls_fraction,
    pareto_frontier,
    routed_points,
)
from repro_torch.core.model_repr import build_model_embeddings, embed_new_model
from repro_torch.core.router import (
    PredictiveRouter,
    evaluate_sweep,
    oracle_sweep,
)
from repro_torch.core.clustering import kmeans, pairwise_sq_dists

__all__ = [
    "ENSEMBLE_KINDS", "PREDICTORS", "REWARDS", "attention_scores",
    "cascade_outcome", "cascade_reward", "reward_exponential",
    "reward_linear", "route", "DEFAULT_LAMBDA_GRID", "aiq", "evaluate_router",
    "frontier_dominance", "frontier_value_at",
    "lam_sensitivity", "max_calls_fraction", "pareto_frontier",
    "routed_points", "build_model_embeddings", "embed_new_model",
    "PredictiveRouter", "evaluate_sweep", "oracle_sweep", "kmeans",
    "pairwise_sq_dists",
]
