"""Plain AdamW: bias-corrected moments, the cosine learning rate taken at
the incremented step (clamped at ``t_max``), decoupled weight decay
lr · wd · p on the old p."""
from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(cfg: Dict, t: int) -> float:
    if cfg.get("t_max") is None:
        return cfg["lr"]
    tt = min(t, cfg["t_max"])
    return cfg.get("eta_min", 0.0) + (cfg["lr"] - cfg.get("eta_min", 0.0)) * 0.5 * (
        1.0 + math.cos(math.pi * tt / cfg["t_max"]))


class AdamW:
    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor]):
        self.cfg = cfg
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        c = self.cfg
        self.t += 1
        lr = lr_at(c, self.t)
        bc1, bc2 = 1.0 - c["b1"] ** self.t, 1.0 - c["b2"] ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(c["b1"]).add_((1 - c["b1"]) * g)
            self.v[k].mul_(c["b2"]).add_((1 - c["b2"]) * g * g)
            delta = lr * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + c["eps"])
            delta = delta + lr * c["weight_decay"] * p
            p.sub_(delta)

