"""Step functions of LM training and generation: train, prefill, decode.

The port of ``repro.launch.steps`` for one device. Each factory closes
over the config; the reference also takes a mesh and installs its
logical-axis sharding rules inside the step. Multi-device placement is
not ported yet (ROADMAP Queue 1, item 12b: ``launch/mesh.py``,
``launch/sharding.py``, ``models/sharding_ctx.py``), so a ``mesh`` other
than ``None`` raises ``NotImplementedError``; there is no fallback.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.common.tree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm as lm_mod
from repro_torch.training.optim import AdamConfig, adam_update, value_and_grad

TRAIN_ADAM = AdamConfig(lr=3e-4, b1=0.9, b2=0.95, weight_decay=0.1)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port's LM steps run on one device: a mesh needs launch/mesh.py, "
            "launch/sharding.py and models/sharding_ctx.py, not ported yet "
            "(ROADMAP Queue 1, item 12b); pass mesh=None")


def _loss(cfg: ArchConfig, params: Dict, batch: Dict) -> torch.Tensor:
    return lm_mod.lm_loss(cfg, params, batch["tokens"], batch["labels"],
                          media=batch.get("media"), attn_mask=batch.get("attn_mask"))


def make_train_step(cfg: ArchConfig, mesh=None, adam_cfg: AdamConfig = TRAIN_ADAM,
                    microbatch: int = 1, rules_override: Optional[Dict] = None):
    """(params, opt_state, batch) -> (loss, params, opt_state).

    ``batch`` holds ``tokens`` and ``labels`` (B, S), and may hold
    ``attn_mask`` (B, S) bool and ``media``. ``microbatch > 1`` accumulates
    gradients: the batch's leading axis is split into ``microbatch``
    chunks, run one after another, whose losses and grads are summed and
    then scaled by ``1 / microbatch``, as the reference does.
    ``rules_override`` amends a mesh's sharding rules, so it is unused
    here. The step takes the params and optimizer state over, as the
    reference's ``train_loop`` donates both to its jitted step: each new
    leaf is written into its old tensor as soon as it exists
    (``adam_update(..., donate=True)``), so the returned trees are the
    ones given, updated, and old and new never coexist.
    """
    _no_mesh(mesh)

    def grad_fn(params, batch):
        if microbatch <= 1:
            return value_and_grad(lambda p: _loss(cfg, p, batch), params)
        b = batch["tokens"].shape[0]
        if b % microbatch:
            raise ValueError(f"batch {b} is not a multiple of microbatch {microbatch}")
        size = b // microbatch
        loss_sum, gsum = torch.zeros((), dtype=torch.float32,
                                     device=batch["tokens"].device), None
        for i in range(microbatch):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, grads = value_and_grad(lambda p: _loss(cfg, p, mb), params)
            loss_sum = loss_sum + loss
            gsum = grads if gsum is None else tree_map(torch.Tensor.add_, gsum, grads)
        inv = 1.0 / microbatch
        return loss_sum * inv, tree_map(lambda g: g.mul_(inv), gsum)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        params, opt_state = adam_update(adam_cfg, grads, opt_state, params, donate=True)
        return loss, params, opt_state

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh=None):
    """(params, batch{tokens, caches[, media]}) -> (last_logits, caches)."""
    _no_mesh(mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        return lm_mod.apply_lm_prefill(cfg, params, batch["tokens"], batch["caches"],
                                       media=batch.get("media"))

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None):
    """(params, batch{token, caches, pos}) -> (logits, caches)."""
    _no_mesh(mesh)

    @torch.no_grad()
    def decode_step(params, batch):
        return lm_mod.apply_lm_decode(cfg, params, batch["token"], batch["caches"],
                                      int(batch["pos"]))

    return decode_step
