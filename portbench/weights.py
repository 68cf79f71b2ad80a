"""Seeded weights made on the device by the benchmark, in the layout the
port's models read (the tree of ``repro_torch.models.lm.abstract_params``).

One float32 buffer per model is filled from a ``torch.Generator`` on the
device in a few large normal draws; every leaf is a view of it, scaled in
place: matrices by 1/sqrt(fan_in), the embedding table by 0.02, norm
scales to 1 + 0.1·N(0, 1). The same seed gives the same weights, so the
plain reference can make them again.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

CHUNK = 1 << 28   # elements per draw


def leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in the tree's order; dict keys and list indices
    joined by '/'."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def rebuild(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: rebuild(v, values, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, values, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return values[prefix[:-1]]


def _scale(path: str, t: torch.Tensor) -> None:
    name = path.rsplit("/", 1)[-1]
    if name == "scale":
        t.mul_(0.1).add_(1.0)
    elif name == "table":
        t.mul_(0.02)
    elif t.dim() >= 2:
        t.mul_(1.0 / math.sqrt(t.shape[-2]))
    else:
        t.mul_(0.02)


def make_params(shapes: Any, seed: int, device) -> Dict:
    """Params shaped as ``shapes`` (a tree of tensors, meta ones will do),
    float32 on ``device``."""
    flat = leaves(shapes)
    total = sum(int(t.numel()) for _, t in flat)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    for lo in range(0, total, CHUNK):
        buf[lo:lo + CHUNK].normal_(generator=gen)
    out, off = {}, 0
    for path, t in flat:
        n = int(t.numel())
        view = buf[off:off + n].view(tuple(t.shape))
        _scale(path, view)
        out[path] = view
        off += n
    return rebuild(shapes, out)


def param_bytes(params: Any) -> int:
    return sum(int(t.numel()) * t.element_size() for _, t in leaves(params))
