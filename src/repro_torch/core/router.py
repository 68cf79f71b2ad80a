"""Predictor-based routing framework (paper §3).

A :class:`PredictiveRouter` bundles a quality predictor and a cost
predictor; routing is ``argmax_m Reward(s_hat, c_hat; lambda)``. The
port of ``repro.core.router.PredictiveRouter`` for serving: predictor
params are dicts of tensors on the serving device, while the model
embeddings, the cost scaler and every returned score stay numpy, as in
the reference, so the float64 cost arithmetic matches it bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import rewards as rewards_mod
from repro_torch.core.predictors import PREDICTORS


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
        return next(iter(self.quality_params.values())).device

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

    @torch.inference_mode()
    def predict(self, q_emb: np.ndarray):
        """(s_hat, c_hat) numpy, both (B, K), through the plain predictors.

        Queries are scored in float32 (the featurizer returns float64; the
        reference's ``jnp.asarray`` narrows it with x64 off).
        """
        m = self.model_emb_tensor()
        q = torch.as_tensor(np.asarray(q_emb, np.float32), device=self.device)
        s_hat = PREDICTORS[self.quality_kind].apply(self.quality_params, q, m)
        c_hat = PREDICTORS[self.cost_kind].apply(self.cost_params, q, m)
        return s_hat.cpu().numpy(), self.denormalize_cost(c_hat.cpu().numpy())

    def route(self, q_emb: np.ndarray, lam: float) -> np.ndarray:
        s_hat, c_hat = self.predict(q_emb)
        return rewards_mod.route(self.reward, torch.from_numpy(s_hat),
                                 torch.from_numpy(c_hat), lam).numpy()
