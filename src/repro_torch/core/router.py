"""Predictor-based routing framework (paper §3).

A :class:`PredictiveRouter` bundles a quality predictor and a cost
predictor; routing is ``argmax_m Reward(s_hat, c_hat; lambda)``. Training
of the predictors is decoupled from lambda, so one trained router serves
the whole lambda sweep. The oracle router applies the same reward to the
*true* (s, c), the gold standard for each reward function.

The port of ``repro.core.router``: predictor params are dicts of tensors
on the router's device, while the model embeddings, the cost scaler and
every returned score stay numpy, as in the reference, so the float64 cost
arithmetic matches it bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.tree import flatten_with_paths
from repro_torch.core import rewards as rewards_mod
from repro_torch.core.metrics import DEFAULT_LAMBDA_GRID, evaluate_router
from repro_torch.core.predictors import ENSEMBLE_KINDS, PREDICTORS


def _grow(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with one more slice along ``dim``: the mean of the others."""
    return torch.cat([t, t.mean(dim=dim, keepdim=True)], dim=dim)


def _drop(t: torch.Tensor, dim: int, idx: int) -> torch.Tensor:
    keep = [i for i in range(t.shape[dim]) if i != idx]
    return t.index_select(dim, torch.tensor(keep, device=t.device))


def _pool_axis_leaves(kind: str, params: Dict):
    """The output head's member-axis leaves of a non-pool-free kind:
    ``[(path, dim)]`` with path a tuple of dict keys."""
    if kind == "attn":
        return [(("wo",), 1), (("bo",), 0)]
    if kind == "reg":
        return [(("w",), 1), (("b",), 0)]
    if kind == "attn-ens":
        # Per-head output maps carry a leading head axis: (H, d, K), (H, K).
        return [(("wo",), 2), (("bo",), 1)]
    if kind in ("2fcn", "3fcn"):
        last = f"layer{len(params) - 1}"
        return [((last, "w"), 1), ((last, "b"), 0)]
    raise ValueError(f"no pool-axis rule for predictor {kind!r}")


def _map_pool_axis(kind: str, params: Dict, fn) -> Dict:
    """Apply ``fn(leaf, dim)`` to the member-axis leaves; other leaves are
    shared with ``params``, which is not changed."""
    if PREDICTORS[kind].pool_free:
        return params
    out = dict(params)
    for path, dim in _pool_axis_leaves(kind, params):
        if len(path) == 2:
            out[path[0]] = dict(out[path[0]])
            out[path[0]][path[1]] = fn(params[path[0]][path[1]], dim)
        else:
            out[path[0]] = fn(params[path[0]], dim)
    return out


def _expand_pool_axis(kind: str, params: Dict) -> Dict:
    """Grow a non-pool-free predictor's output head by one member column,
    cold-started at the mean of the existing columns (per head for
    ``attn-ens``, so the heads' spread on the newcomer starts nonzero)."""
    return _map_pool_axis(kind, params, _grow)


def _drop_pool_axis(kind: str, params: Dict, idx: int) -> Dict:
    """Remove member ``idx``'s column from a non-pool-free output head."""
    return _map_pool_axis(kind, params, lambda t, dim: _drop(t, dim, idx))


@dataclasses.dataclass
class PredictiveRouter:
    quality_kind: str
    cost_kind: str
    quality_params: Dict
    cost_params: Dict
    model_emb: np.ndarray            # (K, C)
    reward: str = "R2"
    cost_scaler: Optional[Dict] = None   # {"mu","sd"} from the cost trainer
    # Versioned so the serving engine can swap whole routers and reject
    # stale publishes; the k-means centroids ride along for the online layer.
    version: int = 0
    centroids: Optional[np.ndarray] = None   # (C, d_query) from clustering

    @property
    def n_members(self) -> int:
        return int(np.asarray(self.model_emb).shape[0])

    @property
    def device(self) -> torch.device:
        return next(iter(flatten_with_paths(self.quality_params).values())).device

    def with_updates(
        self,
        quality_params: Optional[Dict] = None,
        cost_params: Optional[Dict] = None,
        model_emb: Optional[np.ndarray] = None,
    ) -> "PredictiveRouter":
        """Next router version with some state replaced (never mutated)."""
        return dataclasses.replace(
            self,
            quality_params=(self.quality_params if quality_params is None
                            else quality_params),
            cost_params=self.cost_params if cost_params is None else cost_params,
            model_emb=self.model_emb if model_emb is None else model_emb,
            version=self.version + 1,
        )

    def add_member(self, emb_row: Optional[np.ndarray] = None) -> "PredictiveRouter":
        """Grow the pool by one member (hot membership).

        ``emb_row`` (C,) is the new member's model embedding; it defaults
        to the mean of the existing rows. Non-pool-free heads grow a
        cold-started output column; a per-member cost scaler grows by its
        mean.
        """
        memb = np.asarray(self.model_emb)
        if emb_row is None:
            emb_row = memb.mean(axis=0)
        emb_row = np.asarray(emb_row, memb.dtype).reshape(1, -1)
        scaler = self.cost_scaler
        if scaler is not None and np.ndim(scaler["mu"]) == 1:
            scaler = {
                "mu": np.append(scaler["mu"], scaler["mu"].mean()),
                "sd": np.append(scaler["sd"], scaler["sd"].mean()),
            }
        return dataclasses.replace(
            self,
            quality_params=_expand_pool_axis(self.quality_kind, self.quality_params),
            cost_params=_expand_pool_axis(self.cost_kind, self.cost_params),
            model_emb=np.concatenate([memb, emb_row], axis=0),
            cost_scaler=scaler,
            version=self.version + 1,
        )

    def remove_member(self, idx: int) -> "PredictiveRouter":
        """Shrink the pool: drop member ``idx`` (members above shift down)."""
        memb = np.asarray(self.model_emb)
        if not 0 <= idx < memb.shape[0]:
            raise IndexError(f"member {idx} out of range 0..{memb.shape[0]-1}")
        if memb.shape[0] <= 1:
            raise ValueError("cannot remove the last pool member")
        scaler = self.cost_scaler
        if scaler is not None and np.ndim(scaler["mu"]) == 1:
            scaler = {
                "mu": np.delete(scaler["mu"], idx),
                "sd": np.delete(scaler["sd"], idx),
            }
        return dataclasses.replace(
            self,
            quality_params=_drop_pool_axis(self.quality_kind, self.quality_params, idx),
            cost_params=_drop_pool_axis(self.cost_kind, self.cost_params, idx),
            model_emb=np.delete(memb, idx, axis=0),
            cost_scaler=scaler,
            version=self.version + 1,
        )

    def denormalize_cost(self, c_hat: np.ndarray) -> np.ndarray:
        """Undo the cost trainer's target normalization and clamp at zero.

        Numpy, as in the reference: a float64 scaler makes the result
        float64. Every scoring path goes through here.
        """
        c_hat = np.asarray(c_hat)
        if self.cost_scaler is not None:
            c_hat = c_hat * self.cost_scaler["sd"] + self.cost_scaler["mu"]
        return np.maximum(c_hat, 0.0)

    def model_emb_tensor(self) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.model_emb), device=self.device)

    def _query(self, q_emb: np.ndarray) -> torch.Tensor:
        """Queries in float32 on the router's device (the featurizer returns
        float64; the reference's ``jnp.asarray`` narrows it with x64 off)."""
        return torch.as_tensor(np.asarray(q_emb, np.float32), device=self.device)

    @torch.inference_mode()
    def predict(self, q_emb: np.ndarray):
        """(s_hat, c_hat) numpy, both (B, K), through the plain predictors."""
        m, q = self.model_emb_tensor(), self._query(q_emb)
        s_hat = PREDICTORS[self.quality_kind].apply(self.quality_params, q, m)
        c_hat = PREDICTORS[self.cost_kind].apply(self.cost_params, q, m)
        return s_hat.cpu().numpy(), self.denormalize_cost(c_hat.cpu().numpy())

    @torch.inference_mode()
    def predict_with_uncertainty(self, q_emb: np.ndarray):
        """(s_mean, s_std, c_hat), each (B, K).

        For ensemble quality kinds ``s_std`` is the heads' population
        standard deviation (ddof 0, as ``np.std``); other kinds report zero.
        """
        heads_apply = ENSEMBLE_KINDS.get(self.quality_kind)
        if heads_apply is None:
            s_hat, c_hat = self.predict(q_emb)
            return s_hat, np.zeros_like(s_hat), c_hat
        m, q = self.model_emb_tensor(), self._query(q_emb)
        per_head = heads_apply(self.quality_params, q, m)
        c_hat = PREDICTORS[self.cost_kind].apply(self.cost_params, q, m)
        return (per_head.mean(dim=0).cpu().numpy(),
                per_head.std(dim=0, correction=0).cpu().numpy(),
                self.denormalize_cost(c_hat.cpu().numpy()))

    def route(self, q_emb: np.ndarray, lam: float) -> np.ndarray:
        s_hat, c_hat = self.predict(q_emb)
        return rewards_mod.route(self.reward, s_hat, c_hat, lam).numpy()

    def sweep(self, q_emb: np.ndarray, lams: Sequence[float]) -> np.ndarray:
        """(L, B) routed indices across the lambda grid (one predict pass)."""
        s_hat, c_hat = self.predict(q_emb)
        return np.stack([rewards_mod.route(self.reward, s_hat, c_hat, lam).numpy()
                         for lam in lams])


def oracle_sweep(
    quality: np.ndarray, cost: np.ndarray, lams: Sequence[float], reward: str,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Oracle router choices (true s, c) across the lambda grid: (L, B).
    The rewards are taken on ``device`` when one is given, else on the
    CPU from the numpy arrays as they are."""
    if device is not None:
        quality, cost = (torch.as_tensor(a, device=device) for a in (quality, cost))
    return np.stack([rewards_mod.route(reward, quality, cost, lam).cpu().numpy()
                     for lam in lams])


def evaluate_sweep(
    choices: np.ndarray,
    quality: np.ndarray,
    cost: np.ndarray,
    lams: Optional[np.ndarray] = None,
    expensive_idx: Optional[int] = None,
) -> Dict[str, float]:
    lams = DEFAULT_LAMBDA_GRID if lams is None else lams
    if expensive_idx is None:
        expensive_idx = int(np.argmax(cost.mean(axis=0)))
    return evaluate_router(choices, quality, cost, lams, expensive_idx)
