"""Router checkpoints in the reference's npz layout.

``save_router``/``load_router`` read and write the same files as
``repro.checkpoint``: every leaf under its ``a/b/c`` tree path, plus a
JSON meta blob stored as uint8 bytes under ``__repro_meta__``. Either
package loads what the other saved, which is also how a trained router
crosses from the reference to the port.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import flatten_with_paths, tree_map

_META_KEY = "__repro_meta__"
ROUTER_CKPT_KIND = "predictive_router_v1"


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    """Write ``tree``'s leaves as numpy arrays under their paths, atomically."""
    arrays = {k: _to_numpy(v) for k, v in flatten_with_paths(tree).items()}
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _nest_flat(flat: Dict[str, np.ndarray]) -> Dict:
    """Rebuild nested dicts from ``a/b/c`` leaf paths; leaves stay numpy."""
    root: Dict = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return root


def save_router(path: str, router, pool_names=None) -> None:
    """Persist a PredictiveRouter: params + version + scaler meta.

    The cost scaler rides in the array tree, not the JSON meta, so its
    float64 dtype survives byte-exactly. ``pool_names`` records which pool
    members the router's member axis refers to.
    """
    tree = {
        "quality": router.quality_params,
        "cost": router.cost_params,
        "model_emb": np.asarray(router.model_emb),
    }
    if router.centroids is not None:
        tree["centroids"] = np.asarray(router.centroids)
    if router.cost_scaler is not None:
        tree["cost_scaler"] = {
            "mu": np.asarray(router.cost_scaler["mu"]),
            "sd": np.asarray(router.cost_scaler["sd"]),
        }
    meta = {
        "kind": ROUTER_CKPT_KIND,
        "quality_kind": router.quality_kind,
        "cost_kind": router.cost_kind,
        "reward": router.reward,
        "version": int(router.version),
    }
    if pool_names is not None:
        meta["pool_names"] = list(pool_names)
    save_checkpoint(path, tree, meta)


def load_router(path: str, expect_pool_names=None,
                device: Optional[DeviceLike] = None):
    """Restore a PredictiveRouter saved by either package's ``save_router``.

    Predictor params land on ``device`` (the CUDA card unless the caller
    names another). ``expect_pool_names``: when given and the checkpoint
    recorded its pool names, the two must match exactly, order included —
    the member axis is positional and a same-size pool swap would
    otherwise misroute silently.
    """
    from repro_torch.core.router import PredictiveRouter

    device = resolve_device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META_KEY]).decode("utf-8"))
        flat = {k: data[k] for k in data.files if k != _META_KEY}
    if meta.get("kind") != ROUTER_CKPT_KIND:
        raise ValueError(
            f"{path!r} is not a router checkpoint "
            f"(kind={meta.get('kind')!r}, want {ROUTER_CKPT_KIND!r})")
    saved_names = meta.get("pool_names")
    if (expect_pool_names is not None and saved_names is not None
            and list(expect_pool_names) != list(saved_names)):
        raise ValueError(
            f"router checkpoint was trained for pool {saved_names}, "
            f"not {list(expect_pool_names)} — member columns are "
            "positional and would misroute silently")
    tree = _nest_flat(flat)
    scaler = tree.get("cost_scaler")
    if scaler is not None:
        scaler = {"mu": np.asarray(scaler["mu"]),
                  "sd": np.asarray(scaler["sd"])}
    to_device = lambda t: tree_map(  # noqa: E731
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device), t)
    return PredictiveRouter(
        quality_kind=meta["quality_kind"],
        cost_kind=meta["cost_kind"],
        quality_params=to_device(tree["quality"]),
        cost_params=to_device(tree["cost"]),
        model_emb=np.asarray(tree["model_emb"]),
        reward=meta["reward"],
        cost_scaler=scaler,
        version=int(meta["version"]),
        centroids=(np.asarray(tree["centroids"])
                   if "centroids" in tree else None),
    )
