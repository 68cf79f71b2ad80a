"""Trainer for the routing predictors (paper §5 recipe).

The port of ``repro.training.predictor_trainer``. All predictors train
with MSE, AdamW and the cosine schedule. Paper hypers: quality predictor
lr = 1e-3, wd = 1e-5; cost predictor lr = 1e-4, wd = 1e-7; batch 1024;
75/5/20 split; the params of the best validation loss are kept.

Training runs on ``device``, the CUDA card unless the caller names
another, through plain PyTorch autograd: the reference trains through
plain ``jnp`` too, and the ``router_xattn`` kernel is forward-only (it
scores the trained router at serving time). The reference's semantics
are kept exactly:

  * embeddings and targets reach the device as float32 once, and batches
    are indexed there;
  * ``steps_per_epoch = max(1, n // batch_size)`` drops the tail;
  * two numpy generators seeded with ``cfg.seed``: the Poisson(1)
    bootstrap weights of ensemble kinds come from the first, the epoch
    permutations from the second;
  * validation runs every ``eval_every`` epochs and at the last one, and
    the best params are a real copy (updates make new tensors, and the
    copy is cloned besides, so no later step can reach it);
  * one ``float(loss)`` per step, as the reference's loop does.

The reference draws initial params from ``jax.random``, which torch cannot
reproduce: ``init_params`` lets a caller start from given params (the
parity tests start from the reference's); without it they come from a
``torch.Generator`` on the device seeded with ``cfg.seed``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.core.predictors import ENSEMBLE_KINDS, PREDICTORS
from repro_torch.training.optim import AdamConfig, adam_init, adam_update, value_and_grad


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-5
    batch_size: int = 1024
    epochs: int = 200
    seed: int = 0
    eval_every: int = 10


# Paper §5 settings per predictor role.
QUALITY_TRAIN = TrainConfig(lr=1e-3, weight_decay=1e-5)
COST_TRAIN = TrainConfig(lr=1e-4, weight_decay=1e-7)


@functools.lru_cache(maxsize=64)
def make_predictor_step(kind: str, opt_cfg: AdamConfig):
    """Step for dense (B, K) targets:
    ``step(params, state, q (B,dq), m (K,dm), targets (B,K)) ->
    (loss, params, state)``."""
    pred = PREDICTORS[kind]

    def loss_fn(p, q, m, t):
        return torch.mean((pred.apply(p, q, m) - t) ** 2)

    def step(params, state, q, m, t):
        loss, grads = value_and_grad(loss_fn, params, q, m, t)
        params, state = adam_update(opt_cfg, grads, state, params)
        return loss, params, state

    return step


@functools.lru_cache(maxsize=64)
def make_ensemble_predictor_step(kind: str, opt_cfg: AdamConfig):
    """Step for deep-ensemble kinds with per-head bootstrap weights:
    ``step(params, state, q (B,dq), m (K,dm), t (B,K), w (B,H)) ->
    (loss, params, state)``. Head ``h`` sees example ``i`` with loss
    weight ``w[i, h]`` (Poisson(1) counts: bagging through a shared
    trunk)."""
    heads_apply = ENSEMBLE_KINDS[kind]

    def loss_fn(p, q, m, t, w):
        out = heads_apply(p, q, m)                   # (H, B, K)
        err = (out - t[None, :, :]) ** 2
        wm = w.T[:, :, None]                         # (H, B, 1)
        return torch.sum(err * wm) / (torch.sum(wm) * t.shape[1] + 1e-9)

    def step(params, state, q, m, t, w):
        loss, grads = value_and_grad(loss_fn, params, q, m, t, w)
        params, state = adam_update(opt_cfg, grads, state, params)
        return loss, params, state

    return step


@functools.lru_cache(maxsize=64)
def make_masked_predictor_step(kind: str, opt_cfg: AdamConfig):
    """Step for online outcome tuples, one observed member per example:
    ``step(params, state, q (B,dq), m (K,dm), member (B,) int64,
    target (B,)) -> (loss, params, state)``. The MSE is taken on the
    routed member's prediction only; ensemble kinds train through their
    mean."""
    pred = PREDICTORS[kind]

    def loss_fn(p, q, m, member, t):
        chosen = torch.gather(pred.apply(p, q, m), 1, member[:, None])[:, 0]
        return torch.mean((chosen - t) ** 2)

    def step(params, state, q, m, member, t):
        loss, grads = value_and_grad(loss_fn, params, q, m, member, t)
        params, state = adam_update(opt_cfg, grads, state, params)
        return loss, params, state

    return step


def _f32(a, device) -> torch.Tensor:
    """A host array on ``device`` as float32, narrowed once on the host
    as the reference's ``jnp.asarray`` narrows float64."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def train_predictor(
    kind: str,
    q_emb: np.ndarray,            # (N, dq)
    targets: np.ndarray,          # (N, K)
    model_emb: np.ndarray,        # (K, C)
    cfg: TrainConfig,
    val: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    *,
    init_params: Optional[Dict] = None,
    device: Optional[DeviceLike] = None,
) -> Tuple[Dict, Dict[str, list]]:
    """Train one predictor with MSE. Returns (best_params, history)."""
    device = resolve_device(device)
    pred = PREDICTORS[kind]
    n, dq = q_emb.shape
    k = targets.shape[1]
    m = _f32(model_emb, device)
    if init_params is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        params = pred.init(gen, dq, k, model_emb.shape[1])
    else:
        params = tree_map(lambda t: torch.as_tensor(t).detach().to(device).clone(),
                          init_params)

    steps_per_epoch = max(1, n // cfg.batch_size)
    opt_cfg = AdamConfig(lr=cfg.lr, weight_decay=cfg.weight_decay,
                         t_max=cfg.epochs * steps_per_epoch)
    state = adam_init(opt_cfg, params)
    boot = None
    if kind in ENSEMBLE_KINDS:
        # One fixed Poisson(1) resample per head, drawn once, so every
        # epoch shows each head the same resampled world.
        n_heads = int(params["bo"].shape[0])
        boot = _f32(np.random.default_rng(cfg.seed).poisson(
            1.0, size=(n, n_heads)), device)
        step = make_ensemble_predictor_step(kind, opt_cfg)
    else:
        step = make_predictor_step(kind, opt_cfg)

    rng = np.random.default_rng(cfg.seed)
    qj, tj = _f32(q_emb, device), _f32(targets, device)
    if val is not None:
        qv, tv = _f32(val[0], device), _f32(val[1], device)
    best_params, best_val = params, np.inf
    history = {"train_loss": [], "val_loss": []}
    for epoch in range(cfg.epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(device)
        ep_loss = 0.0
        for i in range(steps_per_epoch):
            idx = perm[i * cfg.batch_size: (i + 1) * cfg.batch_size]
            if boot is not None:
                loss, params, state = step(params, state, qj[idx], m, tj[idx], boot[idx])
            else:
                loss, params, state = step(params, state, qj[idx], m, tj[idx])
            ep_loss += float(loss)
        history["train_loss"].append(ep_loss / steps_per_epoch)
        if val is not None and (epoch % cfg.eval_every == 0 or epoch == cfg.epochs - 1):
            with torch.no_grad():
                vl = float(torch.mean((pred.apply(params, qv, m) - tv) ** 2))
            history["val_loss"].append(vl)
            if vl < best_val:
                best_val = vl
                best_params = tree_map(lambda x: x.detach().clone(), params)
    if val is None:
        best_params = params
    return best_params, history


def train_dual_predictors(
    quality_kind: str,
    cost_kind: str,
    q_emb_train: np.ndarray,
    quality_train: np.ndarray,
    cost_train: np.ndarray,
    model_emb: np.ndarray,
    *,
    q_emb_val=None, quality_val=None, cost_val=None,
    epochs: int = 200,
    seed: int = 0,
    device: Optional[DeviceLike] = None,
    quality_init: Optional[Dict] = None,
    cost_init: Optional[Dict] = None,
):
    """Trains the (quality, cost) pair with the paper's per-role hypers.

    Costs are normalized to zero mean and unit std per model in numpy, in
    the costs' own dtype (float64 for the serving pool), before anything
    is narrowed; sd = std + 1e-9, so a constant cost column normalizes to
    0. The caller restores them at predict time with the returned scaler. Returns (quality params, cost params,
    scaler, {"quality": history, "cost": history}).
    """
    qcfg = dataclasses.replace(QUALITY_TRAIN, epochs=epochs, seed=seed)
    ccfg = dataclasses.replace(COST_TRAIN, epochs=epochs, seed=seed + 1)
    qval = (q_emb_val, quality_val) if q_emb_val is not None else None

    mu, sd = cost_train.mean(0), cost_train.std(0) + 1e-9
    cost_norm = (cost_train - mu) / sd
    cval = None
    if q_emb_val is not None and cost_val is not None:
        cval = (q_emb_val, (cost_val - mu) / sd)

    q_params, q_hist = train_predictor(
        quality_kind, q_emb_train, quality_train, model_emb, qcfg, qval,
        init_params=quality_init, device=device)
    c_params, c_hist = train_predictor(
        cost_kind, q_emb_train, cost_norm, model_emb, ccfg, cval,
        init_params=cost_init, device=device)
    scaler = {"mu": mu, "sd": sd}
    return q_params, c_params, scaler, {"quality": q_hist, "cost": c_hist}
