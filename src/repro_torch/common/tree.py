"""Flat ``a/b/0/c`` paths over parameter trees (the checkpoint format).

Parameter trees in the port are nested dicts, lists and tuples of tensors
or numpy arrays. Dict keys are visited in sorted order, as JAX flattens
dicts, so a tree flattens to the same paths in the same order as its
counterpart in :mod:`repro.common.tree`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np


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


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping dict/list/tuple structure; with
    ``rest``, to the leaves of ``tree`` and of each tree of the same
    structure beside it, as ``jax.tree.map`` does."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_paths(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """Apply ``fn(path, leaf)`` to every leaf, keeping dict/list/tuple
    structure; ``path`` is the leaf's :func:`flatten_with_paths` key."""
    def sub(key):
        return f"{prefix}/{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, sub(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def unflatten_from_paths(tree_like: Any, flat: Dict[str, Any]) -> Any:
    """Rebuild a tree with the structure of ``tree_like`` from a flat dict.

    Dicts come back with ``tree_like``'s keys in sorted order, as JAX
    rebuilds them (the serving codec writes a dict in its order); lists
    and tuples keep their type and order (``"10"`` comes after ``"9"``,
    whatever the flat dict's order). A path of ``tree_like`` missing from
    ``flat`` raises ``KeyError``; a leaf of another shape than
    ``tree_like``'s raises ``ValueError``.
    """
    return _unflatten(tree_like, flat, "")


def _unflatten(like: Any, flat: Dict[str, Any], path: str) -> Any:
    # A module-level function, not a recursive closure: a closure that
    # calls itself is a reference cycle, which would hold ``flat`` (a
    # step's gradients) until the garbage collector runs.
    if isinstance(like, dict):
        return {k: _unflatten(like[k], flat, f"{path}/{k}" if path else str(k))
                for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, flat, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(like))
    if path not in flat:
        raise KeyError(f"checkpoint missing parameter {path!r}")
    leaf = flat[path]
    if tuple(np.shape(leaf)) != tuple(np.shape(like)):
        raise ValueError(f"shape mismatch for {path!r}: checkpoint "
                         f"{tuple(np.shape(leaf))} vs model {tuple(np.shape(like))}")
    return leaf


def nest_flat(flat: Dict[str, Any]) -> Dict:
    """Rebuild nested dicts from ``a/b/c`` leaf paths (the inverse of
    :func:`flatten_with_paths` for trees of dicts only: a list comes back
    as a dict keyed ``"0"``, ``"1"``, ...; with a template tree, use
    :func:`unflatten_from_paths`)."""
    root: Dict = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return root
