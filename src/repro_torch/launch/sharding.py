"""Sharding rules: parameters (2-D TP x FSDP), activations, caches, batches.

The port of ``repro.launch.sharding``, table for table. Strategy:
  * Tensor parallel ("model" axis): head/ff/expert/vocab dimension of every
    projection; experts for MoE; d_inner for Mamba/mLSTM value paths.
  * FSDP ("data" axis, plus "pod" folded in when present): the complementary
    weight dimension. Optimizer moments mirror param specs => ZeRO-3.
  * Activations: batch over (pod, data); train shards heads/ff over "model",
    decode shards the KV-cache *sequence* over "model".
  * sLSTM: cell activations replicated (full recurrent coupling is
    TP-hostile); only its big projections shard.

A spec is a tuple over a tensor's dims (``models/sharding_ctx.py``); a
:class:`NamedSharding` pairs it with its mesh, as JAX's does, and gives
the DTensor placements. The port's param leaves are per layer,
``layers/<i>/mixer/wq`` in ``layer_plan()`` order, so a layer's spec is the
reference's for the matching ``pattern/<j>`` or ``remainder/<j>`` leaf
without the leading repeat axis. Caches are a list of per-layer dicts in
the same order.

Rules read a mesh's ``mesh_dim_names`` and ``shape`` only, so a
``DeviceMesh`` and an :class:`~repro_torch.launch.mesh.AbstractMesh` both
serve.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.common.tree import map_with_paths, tree_map
from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM, XATTN, ArchConfig, LayerSpec
from repro_torch.models.sharding_ctx import Spec, spec_to_placements


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``); ``placements`` are the
    DTensor placements it means, one per mesh dim."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple:
        return spec_to_placements(self.mesh, self.spec)


def _replicated(rank: int) -> Spec:
    return (None,) * rank


def batch_axes(mesh):
    """Mesh axes carrying the batch dim: ("pod","data") on the 2-pod mesh."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


def fsdp_axis(mesh):
    """Weight-sharding data axis (ZeRO): pod folded in when present."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


# ---------------------------------------------------------------------------
# Activation logical-axis rule tables (consumed by models/sharding_ctx.py)
# ---------------------------------------------------------------------------

def train_rules(mesh) -> Dict[str, Any]:
    # heads/kv_heads are deliberately unconstrained, as in the reference:
    # kv-head counts (8) below the 16-way model axis would force replication
    # copies when pinned.
    return {
        "batch": batch_axes(mesh),
        "seq": None,
        "embed": None,
        "heads": None,
        "kv_heads": None,
        "ff": "model",
        "ssm_inner": "model",
        "expert": "model",
        "cache_seq": None,
    }


def decode_rules(mesh) -> Dict[str, Any]:
    return {
        "batch": batch_axes(mesh),
        "seq": None,
        "embed": None,
        "heads": None,
        "kv_heads": None,
        "ff": "model",
        "ssm_inner": "model",
        "expert": "model",
        "cache_seq": "model",     # sequence-sharded KV (flash-decoding style)
    }


# ---------------------------------------------------------------------------
# Parameter sharding
# ---------------------------------------------------------------------------

def _attn_param_spec(name: str, rank: int, dp) -> Spec:
    if name in ("wq", "wk", "wv"):
        return (dp, "model")
    if name == "wo":
        return ("model", dp)
    if name in ("bq", "bk", "bv"):
        return ("model",)
    if name == "w_proj":                      # modality projector (Fd, D)
        return (None, "model")
    return _replicated(rank)                  # norms etc.


_MAMBA_SPECS = {
    "in_proj": ("dp", "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "dt_bias": ("model",),
    "A_log": ("model", None),
    "D": ("model",),
    "out_proj": ("model", "dp"),
}

_MLSTM_SPECS = {
    "up_proj": ("dp", "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    # Block-diag (H, dh, dh) per-head projections: q,k shard the
    # contraction dh (outputs replicated, as the state math wants);
    # v shards its OUTPUT dh so the matrix state C shards on dv.
    "wq": (None, "model", None),
    "wk": (None, "model", None),
    "wv": (None, None, "model"),
    "w_igate": ("model", None),
    "w_fgate": ("model", None),
    "skip": ("model",),
    "down_proj": ("model", "dp"),
}


def _table_spec(table: Dict[str, Spec], name: str, rank: int, dp) -> Spec:
    """``table[name]`` with the placeholder ``"dp"`` read as the FSDP axis."""
    if name not in table:
        return _replicated(rank)
    return tuple(dp if ax == "dp" else ax for ax in table[name])


def _slstm_param_spec(name: str, rank: int, dp) -> Spec:
    # Recurrent coupling is TP-hostile: keep cell *activations* replicated,
    # but shard the big input projection on its contraction dim (memory).
    if name == "w":
        return ("model", None)
    if name == "ff_up":
        return (dp, "model")
    if name == "ff_down":
        return ("model", dp)
    return _replicated(rank)


def _ffn_param_spec(name: str, rank: int, dp) -> Spec:
    if rank == 3:                              # MoE expert-stacked weights
        if name in ("w_gate", "w_up"):
            return ("model", dp, None)         # (E, D, F): experts on model
        if name == "w_down":
            return ("model", None, dp)         # (E, F, D)
    if name in ("w_gate", "w_up", "ff_up"):
        return (dp, "model")
    if name in ("w_down", "ff_down"):
        return ("model", dp)
    if name == "router":
        return (None, None)                    # small; replicate
    return _replicated(rank)


def _block_param_spec(spec: LayerSpec, sub: Tuple[str, ...], rank: int, dp) -> Spec:
    """sub e.g. ("mixer", "wq") or ("ffn", "shared", "w_gate") or ("norm1","scale")."""
    head, name = sub[0], sub[-1]
    if head in ("norm1", "norm2"):
        return _replicated(rank)
    if head == "mixer":
        if name == "scale":                    # q_norm/k_norm/proj_norm
            return _replicated(rank)
        if spec.mixer in (ATTN, XATTN):
            return _attn_param_spec(name, rank, dp)
        if spec.mixer == MAMBA:
            return _table_spec(_MAMBA_SPECS, name, rank, dp)
        if spec.mixer == MLSTM:
            return _table_spec(_MLSTM_SPECS, name, rank, dp)
        if spec.mixer == SLSTM:
            return _slstm_param_spec(name, rank, dp)
    if head == "ffn":
        if len(sub) >= 3 and sub[1] == "shared":
            # Shared expert = plain MLP.
            if name in ("w_gate", "w_up"):
                return (dp, "model")
            if name == "w_down":
                return ("model", dp)
        return _ffn_param_spec(name, rank, dp)
    return _replicated(rank)


def param_spec(cfg: ArchConfig, mesh, path: str, rank: int) -> Spec:
    """Spec of one parameter leaf of the port's tree by its path
    (``embedding/table``, ``final_norm/scale``, ``layers/<i>/...``)."""
    dp = fsdp_axis(mesh)
    parts = tuple(path.split("/"))
    if parts[0] == "embedding":
        if parts[1] == "table":                # (V, D)
            return ("model", dp)
        if parts[1] == "head":                 # (D, V)
            return (dp, "model")
    if parts[0] == "layers":
        spec = cfg.layer_plan()[int(parts[1])]
        return _block_param_spec(spec, parts[2:], rank, dp)
    return _replicated(rank)


def param_shardings(cfg: ArchConfig, mesh, params: Any):
    """A :class:`NamedSharding` tree matching ``params`` (any tree whose
    leaves have ``shape``: tensors, fake tensors, the Adam moments)."""
    return map_with_paths(
        lambda path, leaf: NamedSharding(mesh, param_spec(cfg, mesh, path, len(leaf.shape))),
        params)


# ---------------------------------------------------------------------------
# Cache sharding (decode/prefill)
# ---------------------------------------------------------------------------
#
# Argument shardings divide their dimensions exactly in the reference (jit
# requires it), so every rule here checks divisibility and falls back:
#   * batch=1 (long_500k): KV sequence shards over ALL mesh axes instead;
#   * cross-attention media caches (1601 tokens): batch-sharded only.


def _axes_size(mesh, ax) -> int:
    if ax is None:
        return 1
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= mesh.shape[names.index(a)]
    return n


def _divisible(n: int, mesh, ax) -> bool:
    return ax is not None and n % _axes_size(mesh, ax) == 0


def _cache_leaf_spec(mesh, spec: Optional[LayerSpec], name: str,
                     shape: Tuple[int, ...]) -> Spec:
    b_ax = batch_axes(mesh)
    rank = len(shape)
    bsz = shape[0] if rank >= 1 else 1
    bspec = b_ax if _divisible(bsz, mesh, b_ax) else None

    if name in ("k", "v") and rank == 4:
        if spec is not None and spec.mixer == XATTN:
            return (bspec, None, None, None)        # media cache: batch only
        length = shape[1]
        if bspec is None:
            every = tuple(mesh.mesh_dim_names)      # single long request
            if _divisible(length, mesh, every):
                return (None, every, None, None)
        seq_ax = "model" if _divisible(length, mesh, "model") else None
        return (bspec, seq_ax, None, None)
    if name == "slot_pos":
        return _replicated(rank)
    if name == "h" and rank == 3:                   # mamba state (B, di, ds)
        return (bspec, "model" if _divisible(shape[1], mesh, "model") else None, None)
    if name == "conv" and rank == 3:                # (B, dc-1, di)
        return (bspec, None, "model" if _divisible(shape[2], mesh, "model") else None)
    if name == "C" and rank == 4:                   # mlstm (B, H, dk, dv)
        return (bspec, None, None,
                "model" if _divisible(shape[3], mesh, "model") else None)
    if name == "n" and rank == 3:                   # mlstm (B, H, dk)
        return (bspec, None, None)
    if rank >= 1:
        return (bspec,) + _replicated(rank - 1)     # slstm states etc.
    return ()


def cache_shardings(cfg: ArchConfig, mesh, caches: Any):
    """A :class:`NamedSharding` tree matching ``caches``, the port's list of
    per-layer cache dicts in ``layer_plan()`` order."""
    plan = cfg.layer_plan()
    return map_with_paths(
        lambda path, leaf: NamedSharding(mesh, _cache_leaf_spec(
            mesh, plan[int(path.split("/")[0])], path.split("/")[-1], tuple(leaf.shape))),
        caches)


# ---------------------------------------------------------------------------
# Batch input sharding
# ---------------------------------------------------------------------------

def batch_shardings(mesh, batch_tree: Any):
    """Batch-sharded leading dim where it divides, else replicated; a 0-d
    leaf replicated."""
    b = batch_axes(mesh)

    def one(leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, ())
        if not _divisible(leaf.shape[0], mesh, b):
            return NamedSharding(mesh, _replicated(leaf.ndim))
        return NamedSharding(mesh, (b,) + _replicated(leaf.ndim - 1))

    return tree_map(one, batch_tree)


# ---------------------------------------------------------------------------
# Placing trees on a mesh
# ---------------------------------------------------------------------------

def _distribute(tree: Any, shardings: Any):
    return tree_map(lambda t, sh: distribute_tensor(t, sh.mesh, sh.placements),
                    tree, shardings)


def distribute_params(cfg: ArchConfig, mesh, params: Any):
    """``params`` (or a tree of moments mirroring them) as DTensors on
    ``mesh`` under :func:`param_shardings`, placed in ``params``' own
    dicts and lists: each tensor is replaced by its DTensor as soon as that
    is made, so no more than one plain leaf beside its copy is ever alive
    (a pool at published size is never held twice). Returns ``params``."""
    _distribute_into(params, param_shardings(cfg, mesh, params))
    return params


def _distribute_into(tree: Any, shardings: Any) -> None:
    for k in (list(tree) if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], torch.Tensor):
            sh = shardings[k]
            tree[k] = distribute_tensor(tree[k], sh.mesh, sh.placements)
        else:
            _distribute_into(tree[k], shardings[k])


def distribute_caches(cfg: ArchConfig, mesh, caches: Any):
    """Decode caches as DTensors on ``mesh`` under :func:`cache_shardings`."""
    return _distribute(caches, cache_shardings(cfg, mesh, caches))


def distribute_batch(mesh, batch: Dict) -> Dict:
    """A batch's tensors as DTensors on ``mesh`` under
    :func:`batch_shardings`; other leaves (a decode ``pos``) and a
    ``caches`` entry (:func:`distribute_caches`) are left as they are."""
    out = dict(batch)
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = _distribute(v, batch_shardings(mesh, v))
    return out
