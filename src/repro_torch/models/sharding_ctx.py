"""Logical-axis activation sharding.

The port of ``repro.models.sharding_ctx``. Model code names the axes of an
activation (``shard(x, "batch", "seq", "embed")``); a step installs a mesh
and a table from logical names to mesh axes (``launch/sharding.py``), and
``shard`` then redistributes a ``DTensor`` to the placements that the
table gives, where the reference adds a sharding constraint for GSPMD.
Outside a context, or on a plain tensor, ``shard`` returns ``x`` itself,
so the same model code runs unchanged on one device.

A spec is a tuple over the tensor's dims of ``None`` (replicated), a mesh
axis name, or a tuple of names; :func:`spec_to_placements` is the one
converter from a spec to DTensor placements.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._pytree import tree_leaves

from repro_torch.common.tree import tree_map

class _State:
    mesh: Any = None
    rules: Dict[str, Any] = {}


# Process-wide, not per thread: on CUDA, autograd runs a backward pass, and
# the recompute of the code a checkpoint saved, on its own device thread,
# which must see the step's rules (the reference traces on one thread).
_state = _State()

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


def _current() -> Tuple[Any, Dict[str, Any]]:
    return _state.mesh, _state.rules


# Strategies registered once, on the first entry to a context:
#   * log_sigmoid_backward (the xLSTM forget gates' gradient) has none in
#     DTensor; it is elementwise over its tensor arguments;
#   * topk (the MoE router) has one, but DTensor's cache of sharding
#     decisions leaves its ``k`` out of the key, so a top-1 call after a
#     top-2 call of the same shape gets the top-2 output shape. A
#     registered strategy's first int argument joins the key.
_registered = threading.Lock(), []


def _elementwise_shardings(*specs):
    """Replicated, or sharded on one dim alike in every argument of the
    output's rank (a lower-rank argument, as the CUDA log-sigmoid buffer
    of size 0, stays replicated)."""
    ndim = max(s.ndim for s in specs)
    out = [([Replicate()], [Replicate()] * len(specs))]
    for d in range(ndim):
        out.append(([Shard(d)], [Shard(d) if s.ndim == ndim else Replicate()
                                 for s in specs]))
    return out


def _topk_shardings(x, k, dim=-1, largest=True, sorted=True):
    """(values, indices) replicated, or both sharded on a dim other than
    the one ``topk`` reduces."""
    dim = dim % x.ndim
    out = [([Replicate(), Replicate()], [Replicate(), None, None, None, None])]
    for d in range(x.ndim):
        if d != dim:
            out.append(([Shard(d), Shard(d)], [Shard(d), None, None, None, None]))
    return out


def _register_strategies() -> None:
    lock, done = _registered
    with lock:
        if done:
            return
        from torch.distributed.tensor.experimental import register_sharding
        aten = torch.ops.aten
        register_sharding(aten.log_sigmoid_backward.default)(_elementwise_shardings)
        register_sharding(aten.topk.default)(_topk_shardings)
        done.append(True)


@contextlib.contextmanager
def logical_sharding(mesh, rules: Dict[str, Any]):
    """Install ``mesh`` and the logical-axis ``rules`` for the enclosed
    code (process-wide), restoring the previous pair on exit."""
    _register_strategies()
    prev = _current()
    _state.mesh, _state.rules = mesh, dict(rules)
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def logical_to_spec(axes: Sequence[Optional[str]], rules=None) -> Spec:
    """Map logical axis names to a spec under the active (or given) rules."""
    if rules is None:
        rules = _current()[1]
    return tuple(rules.get(a) if a is not None else None for a in axes)


def spec_to_placements(mesh, spec: Spec) -> Tuple:
    """One placement per mesh dim: ``Shard(d)`` on every mesh axis that
    tensor dim ``d`` names (a tuple shards that dim over each of its axes,
    in mesh order), ``Replicate()`` elsewhere and on an axis of size 1,
    where the two hold the same data (and DTensor's views, strict about
    sharded dims, have nothing to refuse). A mesh axis named twice, or
    one the mesh lacks, raises ``ValueError``."""
    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    used = set()
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for ax in (axes if isinstance(axes, tuple) else (axes,)):
            if ax not in names:
                raise ValueError(f"spec {spec} names {ax!r}, not a dim of mesh {names}")
            if ax in used:
                raise ValueError(f"spec {spec} names mesh axis {ax!r} twice")
            used.add(ax)
            if mesh.shape[names.index(ax)] > 1:
                placements[names.index(ax)] = Shard(dim)
    return tuple(placements)


def _axes_size(mesh, axes: MeshAxes) -> int:
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for ax in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh.shape[names.index(ax)]
    return n


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to the placements of its logical ``axes`` under
    the active rules. No context, or a plain tensor: ``x`` itself. A dim
    whose size the mesh axes do not divide (a batch of 1 over 16 ranks)
    stays unsharded: GSPMD pads it for the reference, and DTensor's
    uneven shards would leave most ranks an empty tensor."""
    mesh, rules = _current()
    if mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"shard(): {len(axes)} axes for rank-{x.ndim} array")
    if not isinstance(x, DTensor):
        return x
    spec = tuple(None if ax is None or n % _axes_size(mesh, ax) else ax
                 for n, ax in zip(x.shape, logical_to_spec(axes, rules)))
    return x.redistribute(mesh, spec_to_placements(mesh, spec))


def unflatten(x: torch.Tensor, dim: int, sizes: Tuple[int, ...]) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``. On a mesh, a dim sharded into pieces
    that would cut through its new outer axis (8 KV heads of a projection
    sharded 16 ways) is gathered first: GSPMD pads such a split for the
    reference, DTensor refuses it."""
    if isinstance(x, DTensor):
        d = dim % x.ndim
        mesh, placements = x.device_mesh, list(x.placements)
        ways = [md for md, p in enumerate(placements) if p.is_shard(d)]
        n = 1
        for md in ways:
            n *= mesh.size(md)
        if sizes[0] % n:
            for md in ways:
                placements[md] = Replicate()
            x = x.redistribute(mesh, placements)
    return x.unflatten(dim, sizes)


def merge(x: torch.Tensor, start: int, end: int = -1) -> torch.Tensor:
    """``x.flatten(start, end)``, the inverse of :func:`unflatten`. On a
    mesh its gradient is held to the merged tensor's own placements:
    DTensor would otherwise split a gradient that arrives sharded on the
    merged dim (the output projection's) back into heads, and refuse
    where the shards cut through a head."""
    y = x.flatten(start, end)
    if isinstance(y, DTensor):
        y = DTensor.from_local(y.to_local(), y.device_mesh, y.placements, run_check=False,
                               shape=y.shape, stride=y.stride())
    return y


def _mesh_dims(mesh, axes) -> list:
    names = tuple(mesh.mesh_dim_names)
    return [names.index(a) for a in (axes if isinstance(axes, tuple) else (axes,))
            if a in names]


def batch_local(fn, args: Tuple, dims: Tuple, out=0, *, inner: Optional[str] = None):
    """``fn(*args)`` on this rank's shard, as plain tensors.

    For a computation that is independent per batch row (attention, a
    recurrence over time), and with ``inner`` per index of one more dim
    (a Mamba scan per channel): its ops run unsharded inside, where
    DTensor would otherwise pick a placement per op and may meet a
    reshape it cannot follow. On a mesh, each tensor leaf of ``args[i]``
    is laid out with dim ``dims[i]`` sharded over the batch axes of the
    active rules (an int; ``None``: replicated), or with ``dims[i] =
    (batch dim, inner dim)`` its inner dim also over the axes of the
    logical axis ``inner``; everything else replicated. A plain tensor
    counts as replicated, and a leaf whose dim is not that axis's size (a
    mask broadcast over the batch) stays replicated on it. ``fn`` runs on
    the local tensors, and each tensor leaf of its result comes back as a
    DTensor laid out by ``out`` (one spec for every leaf, or a list of
    specs, one per item of the result). An input replicated where the
    work is split gets the sum of the ranks' gradients. A size the axes
    do not divide stays replicated throughout; with no DTensor,
    ``fn(*args)``."""
    mesh, rules = _current()
    if not any(isinstance(x, DTensor) for x in tree_leaves(args)):
        return fn(*args)
    if mesh is None:
        raise RuntimeError("DTensor inputs outside a logical_sharding context: run them "
                           "through a step of launch/steps.py, which installs the rules")
    groups = [_mesh_dims(mesh, rules.get("batch"))]
    if inner is not None:
        groups.append(_mesh_dims(mesh, rules.get(inner)))

    def spec(d) -> Tuple:
        d = d if isinstance(d, tuple) else (d,)
        return tuple(d) + (None,) * (len(groups) - len(d))

    specs = [spec(d) for d in dims]
    sizes, on = [], []
    for g, mds in enumerate(groups):
        size = next((a.shape[s[g]] for a, s in zip(args, specs)
                     if s[g] is not None and isinstance(a, torch.Tensor)), None)
        ways = 1
        for md in mds:
            ways *= mesh.size(md)
        sizes.append(size)
        on.append(size is not None and ways > 1 and size % ways == 0)

    def placements(s):
        pl = [Replicate()] * mesh.ndim
        for g, d in enumerate(s):
            if on[g] and d is not None:
                for md in groups[g]:
                    pl[md] = Shard(d)
        return tuple(pl)

    def to_local(x, s):
        if not isinstance(x, torch.Tensor):
            return x
        s = tuple(d if d is not None and x.shape[d] == sizes[g] else None
                  for g, d in enumerate(s))
        if not isinstance(x, DTensor):
            if all(d is None for d in s):
                return x
            x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        pl = placements(s)
        # An input replicated where the work is split: its gradient is the
        # sum of the ranks' parts.
        grads = tuple(Partial() if any(on[g] and s[g] is None and md in groups[g]
                                       for g in range(len(groups))) else p
                      for md, p in enumerate(pl))
        return x.redistribute(mesh, pl).to_local(grad_placements=grads)

    def back(y, s):
        if not isinstance(y, torch.Tensor):
            return y
        return DTensor.from_local(y, mesh, placements(spec(s)), run_check=False)

    result = fn(*(tree_map(lambda x, s=s: to_local(x, s), a) for a, s in zip(args, specs)))
    if isinstance(out, list):
        return type(result)(tree_map(lambda y, s=s: back(y, s), r) for r, s in zip(result, out))
    return tree_map(lambda y: back(y, out), result)


def get_rule(name: str, default=None):
    """Read a boolean or strategy entry of the active rule table."""
    return _current()[1].get(name, default)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """Redistribute ``x`` to fully replicated (a weight all-gather when the
    stored tensor is sharded: ZeRO-3's gathered weights)."""
    mesh, _ = _current()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, (Replicate(),) * mesh.ndim)


def gather_fsdp(tree):
    """Gather every DTensor leaf of a param subtree over the FSDP axes,
    keeping its tensor-parallel sharding: ZeRO-3's per-layer weight
    all-gather (its gradient is the matching reduce-scatter). The FSDP
    axes are the batch axes of the active rules (``launch/sharding.py``
    shards weights over the axes that carry the batch). Without it
    DTensor may move a layer's activations to meet a weight's FSDP shard
    instead, and leave partial sums of batch-sized outputs."""
    mesh, rules = _current()
    if mesh is None:
        return tree
    names = tuple(mesh.mesh_dim_names)
    batch = rules.get("batch")
    dims = [names.index(a) for a in (batch if isinstance(batch, tuple) else (batch,))
            if a in names]

    def one(x):
        if not isinstance(x, DTensor) or not any(x.placements[d].is_shard() for d in dims):
            return x
        placements = list(x.placements)
        for d in dims:
            placements[d] = Replicate()
        return x.redistribute(mesh, placements)

    return tree_map(one, tree)


def gather_tree(tree):
    """Replicate every leaf of a param subtree at compute time."""
    if _current()[0] is None:
        return tree
    return tree_map(replicate, tree)
