"""Step functions of LM training and generation: train, prefill, decode.

The port of ``repro.launch.steps``. Each factory closes over the config
and a mesh. With a mesh (a ``DeviceMesh`` with ``data`` and ``model``
dims, ``launch/mesh.py``) the step installs the logical-axis rules inside
its body, as the reference's do: training and prefill take
``train_rules``, decode ``decode_rules`` (``launch/sharding.py``). The
params, moments, batch and caches are then DTensors placed by
``launch/sharding.py``'s ``distribute_*``; the model code's ``shard``
calls redistribute the activations, and plain tensors the model makes
(positions, masks, constants) count as replicated. With ``mesh=None``
nothing is installed and the steps are the one-device steps, bit for bit.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.common.tree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import decode_rules, train_rules
from repro_torch.models import lm as lm_mod
from repro_torch.models.sharding_ctx import logical_sharding
from repro_torch.training.optim import AdamConfig, adam_init, adam_update, value_and_grad

TRAIN_ADAM = AdamConfig(lr=3e-4, b1=0.9, b2=0.95, weight_decay=0.1)


def _check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is ``None`` or a ``DeviceMesh`` with ``data``
    and ``model`` dims (a ``pod`` dim may lead)."""
    if mesh is None:
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (launch/mesh.py), "
                        f"got {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if names not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"mesh dims must be ('data', 'model') or ('pod', 'data', "
                         f"'model'), got {names}")


def _rules(mesh, table, rules_override: Optional[Dict] = None):
    _check_mesh(mesh)
    if mesh is None:
        return None
    return {**table(mesh), **(rules_override or {})}


@contextlib.contextmanager
def _placed(mesh, rules):
    """The rules on ``mesh`` with plain tensors read as replicated, or
    nothing without a mesh."""
    if mesh is None:
        yield
        return
    with logical_sharding(mesh, rules), implicit_replication():
        yield


def _loss(cfg: ArchConfig, params: Dict, batch: Dict) -> torch.Tensor:
    return lm_mod.lm_loss(cfg, params, batch["tokens"], batch["labels"],
                          media=batch.get("media"), attn_mask=batch.get("attn_mask"))


def make_grad_step(cfg: ArchConfig, mesh=None, microbatch: int = 1,
                   rules_override: Optional[Dict] = None):
    """(params, batch) -> (loss, grads): the train step's gradient half,
    under the same rules. ``microbatch > 1`` accumulates gradients: the
    batch's leading axis is split into ``microbatch`` chunks, run one
    after another, whose losses and grads are summed and then scaled by
    ``1 / microbatch``, as the reference does."""
    rules = _rules(mesh, train_rules, rules_override)

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

    def grad_step(params, batch):
        with _placed(mesh, rules):
            loss, grads = grad_fn(params, batch)
        # On a mesh the loss comes back as a plain tensor, whole on every
        # rank (a sum over a sharded batch may still be pending).
        return (loss.full_tensor() if isinstance(loss, DTensor) else loss), grads

    return grad_step


def make_train_step(cfg: ArchConfig, mesh=None, adam_cfg: AdamConfig = TRAIN_ADAM,
                    microbatch: int = 1, rules_override: Optional[Dict] = None,
                    donate: bool = True):
    """(params, opt_state, batch) -> (loss, params, opt_state).

    ``batch`` holds ``tokens`` and ``labels`` (B, S), and may hold
    ``attn_mask`` (B, S) bool and ``media``. The gradients are
    :func:`make_grad_step`'s (``microbatch`` accumulates them).
    ``rules_override`` amends the mesh's train rules (``{"seq": "model"}``,
    ``{"xlstm_gather_params": True}``). The step takes the params and
    optimizer state over, as the reference's ``train_loop`` donates both
    to its jitted step: each new leaf is written into its old tensor as
    soon as it exists (``adam_update(..., donate=True)``), so the returned
    trees are the ones given, updated, and old and new never coexist.
    ``donate=False`` returns new trees instead (the dry-run's
    ``--no-donate``).
    """
    rules = _rules(mesh, train_rules, rules_override)
    grad_step = make_grad_step(cfg, mesh, microbatch, rules_override)

    def train_step(params, opt_state, batch):
        loss, grads = grad_step(params, batch)
        with _placed(mesh, rules):
            params, opt_state = adam_update(adam_cfg, grads, opt_state, params,
                                            donate=donate)
        return loss, params, opt_state

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh=None):
    """(params, batch{tokens, caches[, media]}) -> (last_logits, caches)."""
    rules = _rules(mesh, train_rules)

    @torch.no_grad()
    def prefill_step(params, batch):
        with _placed(mesh, rules):
            return lm_mod.apply_lm_prefill(cfg, params, batch["tokens"], batch["caches"],
                                           media=batch.get("media"))

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None):
    """(params, batch{token, caches, pos}) -> (logits, caches)."""
    rules = _rules(mesh, decode_rules)

    @torch.no_grad()
    def decode_step(params, batch):
        with _placed(mesh, rules):
            return lm_mod.apply_lm_decode(cfg, params, batch["token"], batch["caches"],
                                          int(batch["pos"]))

    return decode_step


def abstract_opt_state(cfg: ArchConfig, abstract_params, adam_cfg: AdamConfig = TRAIN_ADAM):
    """Adam state for ``abstract_params`` (fake tensors, or DTensors over
    fake tensors): moments shaped and placed as the params, allocating
    nothing. Call it under the fake mode that made the params."""
    del cfg  # the moments mirror the params; kept for the reference's signature
    return adam_init(adam_cfg, abstract_params)
