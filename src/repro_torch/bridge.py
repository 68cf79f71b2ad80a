"""Carry the reference's parameters into the port.

The JAX package's params arrive as numpy arrays
(``jax.tree.map(np.asarray, params)``); the port keeps their
``(d_in, d_out)`` layout, so each leaf is a copy. The one change of
structure is the LM's layer stack: the reference stacks the repeated
``pattern``'s params on a leading ``n_repeats`` axis (plus a separate
``remainder``), the port keeps one dict per layer in
:meth:`ArchConfig.layer_plan` order. Router checkpoints cross as files
instead (:func:`repro_torch.checkpoint.load_router`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.common.tree import tree_map


def _tensors(tree, device) -> Dict:
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def lm_params_from_jax(cfg, params: Dict, device) -> Dict:
    """Reference LM params (numpy leaves) -> the port's per-layer layout."""
    layers = []
    pattern = params.get("pattern", ())
    for r in range(cfg.n_repeats):
        for j in range(len(cfg.pattern)):
            layers.append(tree_map(lambda a, r=r: a[r], pattern[j]))
    layers.extend(params.get("remainder", ()))
    if len(layers) != len(cfg.layer_plan()):
        raise ValueError(f"{cfg.name}: got {len(layers)} layers of params, "
                         f"plan has {len(cfg.layer_plan())}")
    return {
        "embedding": _tensors(params["embedding"], device),
        "final_norm": _tensors(params["final_norm"], device),
        "layers": [_tensors(layer, device) for layer in layers],
    }


def router_params_from_jax(params: Dict, device) -> Dict:
    """Reference predictor params (numpy leaves) -> dict of tensors."""
    return _tensors(params, device)
