"""AdamW with the reference's cosine schedule, over trees of tensors.

The port of ``repro.training.optim``, written functionally as the
reference is: ``adam_update`` returns new params and a new state and
changes nothing it was given, unless the caller donates them
(``donate=True``, the LM train step). It keeps three details of the
reference that ``torch.optim.AdamW`` with ``CosineAnnealingLR`` does not:

  * the step counter is incremented before the learning rate is taken,
    so the first update uses lr(t = 1);
  * t is clamped at ``t_max``, where ``CosineAnnealingLR`` cycles on;
  * the decoupled weight decay is lr * wd * p on the old p, added to the
    Adam step.

The step counter and the learning rate stay on the params' device, so an
update makes no host round trip. Moments are float32 by default. Trees
are rebuilt in the structure of the params given (lists stay lists, in
their order), so an LM's ``params["layers"]`` list comes back a list.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.common.tree import flatten_with_paths, tree_map, unflatten_from_paths


class AdamState(NamedTuple):
    step: torch.Tensor      # 0-d int32 on the params' device
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # Cosine annealing (eta_min..lr over t_max steps); None = constant lr.
    t_max: Optional[int] = None
    eta_min: float = 0.0
    moment_dtype: torch.dtype = torch.float32


def cosine_lr(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (float32, on ``step``'s device)."""
    if cfg.t_max is None:
        return torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
    t = torch.clamp(step.to(torch.float32), max=float(cfg.t_max))
    cos = 0.5 * (1.0 + torch.cos(math.pi * t / cfg.t_max))
    return cfg.eta_min + (cfg.lr - cfg.eta_min) * cos


def adam_init(cfg: AdamConfig, params: Any) -> AdamState:
    """Zero moments shaped and placed as the params: a DTensor param gets
    a DTensor moment with its placements (ZeRO-3: moments mirror params)."""
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.moment_dtype)  # noqa: E731
    device = next(iter(flatten_with_paths(params).values())).device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adam_update(cfg: AdamConfig, grads: Any, state: AdamState,
                params: Any, *, donate: bool = False) -> Tuple[Any, AdamState]:
    """One AdamW step. Returns (new_params, new_state).

    ``donate=True`` is the counterpart of the reference's
    ``donate_argnums=(0, 1)``: each new leaf of the params and the moments
    is written into its old tensor as soon as it exists, so the old trees
    are not held beside the new ones; the numbers are the same, and the
    caller must not read the old trees afterwards.
    """
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
        v_new = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        m_hat = m_new / bc1
        v_hat = v_new / bc2
        delta = lr * m_hat / (torch.sqrt(v_hat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + lr * cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - delta).to(p.dtype)
        return p_new, m_new.to(cfg.moment_dtype), v_new.to(cfg.moment_dtype)

    flat_g, flat_m, flat_v = (flatten_with_paths(x) for x in (grads, state.m, state.v))
    if donate:
        for k, p in flatten_with_paths(params).items():
            olds = (p, flat_m[k], flat_v[k])
            for old, new in zip(olds, upd(p, flat_g[k], *olds[1:])):
                old.copy_(new)
        return params, AdamState(step=step, m=state.m, v=state.v)
    out = {k: upd(p, flat_g[k], flat_m[k], flat_v[k])
           for k, p in flatten_with_paths(params).items()}
    new = [unflatten_from_paths(params, {k: o[i] for k, o in out.items()}) for i in range(3)]
    return new[0], AdamState(step=step, m=new[1], v=new[2])


def value_and_grad(loss_fn: Callable, params: Dict, *args) -> Tuple[torch.Tensor, Dict]:
    """(loss, d loss / d params) of ``loss_fn(params, *args)``; the loss is
    detached, the grads have the params' tree."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten_with_paths(params).items()}
    with torch.enable_grad():
        loss = loss_fn(unflatten_from_paths(params, leaves), *args)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), unflatten_from_paths(params, dict(zip(leaves, grads)))


def make_train_step(cfg: AdamConfig, loss_fn: Callable):
    """``(params, state, *batch) -> (loss, params, state)``."""

    def step(params, state, *batch):
        loss, grads = value_and_grad(loss_fn, params, *batch)
        params, state = adam_update(cfg, grads, state, params)
        return loss, params, state

    return step
