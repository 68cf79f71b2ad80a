"""Flat ``a/b/0/c`` paths over parameter trees (the checkpoint format).

Parameter trees in the port are nested dicts, lists and tuples of tensors
or numpy arrays. Dict keys are visited in sorted order, as JAX flattens
dicts, so a tree flattens to the same paths in the same order as its
counterpart in :mod:`repro.common.tree`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict


def flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten a tree into ``{"a/b/0/c": leaf}`` form."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(flatten_with_paths(sub, f"{prefix}/{key}" if prefix else key))
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping dict/list/tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
