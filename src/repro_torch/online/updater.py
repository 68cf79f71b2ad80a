"""Incremental router updater: bounded Adam steps + atomic versioned swap.

Warm-starts from the live :class:`~repro_torch.core.router.PredictiveRouter`'s
parameter trees and runs bounded masked-MSE Adam steps (the reusable step
from :mod:`repro_torch.training.predictor_trainer`) on replay batches. The
live router's leaves are **never mutated** — every step produces fresh
trees, and :meth:`publish` hands the engine one fully-built next-version
router for a single-reference atomic swap. A scorer running concurrently
therefore sees either the complete old or the complete new parameters,
never a mix.

Cost targets go through the router's frozen offline scaler (the same
normalization the offline trainer used), so online and offline gradients
live on the same scale and ``denormalize_cost`` keeps working unchanged.

The port of ``repro.online.updater``. The steps run on the router's
device: ``adam_update`` returns new tensors and reads the old ones only,
so the live router's tensors are never written. Each step moves its
replay batch (host numpy, as the reference samples it) to the device once
and reads each loss with one ``float()``, as the reference's loop does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.training.optim import AdamConfig, adam_init
from repro_torch.training.predictor_trainer import make_masked_predictor_step


@dataclasses.dataclass(frozen=True)
class OnlineUpdateConfig:
    batch_size: int = 64
    steps_per_update: int = 8    # bounded work per scheduled update
    burst_steps: int = 48        # drift alarm -> one concentrated burst
    update_every: int = 32       # outcomes between scheduled updates
    recent_frac: float = 0.5     # replay stratification for update batches
    lr_quality: float = 1e-3
    lr_cost: float = 1e-4
    weight_decay: float = 0.0
    min_buffer: int = 32         # don't update on near-empty replay


class IncrementalUpdater:
    def __init__(self, router, config: Optional[OnlineUpdateConfig] = None):
        self.config = config or OnlineUpdateConfig()
        self._q_opt = AdamConfig(lr=self.config.lr_quality,
                                 weight_decay=self.config.weight_decay)
        self._c_opt = AdamConfig(lr=self.config.lr_cost,
                                 weight_decay=self.config.weight_decay)
        self._q_step = make_masked_predictor_step(router.quality_kind,
                                                  self._q_opt)
        self._c_step = make_masked_predictor_step(router.cost_kind,
                                                  self._c_opt)
        self.total_steps = 0
        self.warm_start(router)

    def warm_start(self, router) -> None:
        """(Re)anchor on a router's current params; resets optimizer moments.

        Also the recovery path after hot pool mutation — param shapes
        changed, so stale Adam moments would be meaningless.
        """
        self.q_params = router.quality_params
        self.c_params = router.cost_params
        self.q_state = adam_init(self._q_opt, self.q_params)
        self.c_state = adam_init(self._c_opt, self.c_params)
        self._scaler = router.cost_scaler
        self._device = router.device

    def _cost_targets(self, c: np.ndarray, member: np.ndarray) -> np.ndarray:
        """Observed $ through the frozen scaler, float32 (host numpy, as the
        reference computes them: float64 when the scaler is)."""
        if self._scaler is not None:
            mu = np.asarray(self._scaler["mu"])
            sd = np.asarray(self._scaler["sd"])
            if mu.ndim == 1:
                c = (c - mu[member]) / sd[member]
            else:
                c = (c - mu) / sd
        return np.asarray(c, np.float32)

    def run_steps(self, replay, model_emb: np.ndarray,
                  n_steps: int) -> Dict[str, float]:
        """Up to ``n_steps`` masked Adam steps on replay batches."""
        cfg = self.config
        losses_q, losses_c = [], []
        dev = self._device
        m = torch.as_tensor(np.asarray(model_emb, np.float32), device=dev)
        for _ in range(n_steps):
            batch = replay.sample(cfg.batch_size,
                                  recent_frac=cfg.recent_frac)
            if batch is None:
                break
            member = batch["member"]
            q = torch.as_tensor(batch["q_emb"], device=dev)
            mt = torch.as_tensor(member.astype(np.int64), device=dev)
            s = torch.as_tensor(batch["s"], device=dev)
            c = torch.as_tensor(self._cost_targets(batch["c"], member),
                                device=dev)
            lq, self.q_params, self.q_state = self._q_step(
                self.q_params, self.q_state, q, m, mt, s)
            lc, self.c_params, self.c_state = self._c_step(
                self.c_params, self.c_state, q, m, mt, c)
            losses_q.append(float(lq))
            losses_c.append(float(lc))
            self.total_steps += 1
        return {
            "steps": len(losses_q),
            "quality_loss": float(np.mean(losses_q)) if losses_q else np.nan,
            "cost_loss": float(np.mean(losses_c)) if losses_c else np.nan,
        }

    def publish(self, engine,
                model_emb: Optional[np.ndarray] = None):
        """Build the next router version and atomically swap it live.

        ``model_emb`` is copied: callers (the membership tracker) keep
        mutating their staging array, and the published router must stay
        immutable — sharing the buffer would let record_outcome write into
        the live router behind the cached pool projections' back.
        """
        new_router = engine.router.with_updates(
            quality_params=self.q_params,
            cost_params=self.c_params,
            model_emb=(None if model_emb is None
                       else np.array(model_emb, copy=True)),
        )
        engine.swap_router(new_router)
        return new_router
