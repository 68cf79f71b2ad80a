"""Mixture-of-experts FFN with capacity dispatch (granite-moe: 32 experts, top-8).

The port of ``repro.models.moe``. The reference dispatches with one-hot
capacity einsums, (tokens, E, C) tensors; here the same assignments are
made by index: a kept (token, slot) writes its token row into its
expert's buffer row ``pos`` and reads the expert's output back from
there. Which assignments are kept is the reference's rule, unchanged:

  * the top-k experts of each token, by descending fp32 router
    probability, their gates renormalised by ``max(sum, 1e-9)``;
  * ``pos`` is the exclusive cumulative count over the flattened
    (T·k, E) one-hot, token-major and slot-minor, so a token's place in
    an expert's buffer depends only on the tokens before it;
  * a slot is kept when ``pos`` is below the capacity
    ``max(k, min(ceil(f·T·k/E), T))`` — with a ``valid`` mask, the same
    formula at the valid-token count, in float32 as XLA evaluates it;
  * pads (``valid`` False) take no buffer position, write nothing, and
    are left out of the aux load-balance loss.

Capacity binds in prefill (capacity factor 1.25), as in the reference;
decode sizes the buffer to the chunk's token count, so it drops nothing
(:func:`apply_moe_decode`). Independent capacity groups (batch rows,
sequence chunks) are dispatched in one pass: their buffers sit side by
side on one axis, so each expert's three matmuls run once per call over
every group. Dropped and pad slots write to one spare buffer row that no
kept slot reads, so the pass needs no host sync.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_mlp, dense_init
from repro_torch.models.sharding_ctx import batch_local, shard


def _expert_init(gen: torch.Generator, e: int, d_in: int, d_out: int) -> torch.Tensor:
    """E stacked fan-in truncated-normal (±3σ) matrices, shape (E, d_in, d_out)."""
    w = torch.empty((e, d_in, d_out), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(d_in))


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> Dict:
    """Router (d, E), experts (E, d, fe) / (E, fe, d), and with
    ``n_shared_experts`` a shared SwiGLU of width ``fe · n_shared``."""
    d, fe, e = cfg.d_model, cfg.resolved_d_ff_expert, cfg.n_experts
    p = {
        "router": dense_init(gen, d, e),
        "w_gate": _expert_init(gen, e, d, fe),
        "w_up": _expert_init(gen, e, d, fe),
        "w_down": _expert_init(gen, e, fe, d),
    }
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, d, fs),
            "w_up": dense_init(gen, d, fs),
            "w_down": dense_init(gen, fs, d),
        }
    return p


def _router_probs(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., E) softmax router probabilities in fp32."""
    return torch.softmax((x @ p["router"]).float(), dim=-1)


def _aux_groups(probs: torch.Tensor, expert_mask: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Switch-style load-balance loss per group: probs and expert_mask
    (G, T, E), valid (G, T) bool or None -> (G,)."""
    e = probs.shape[-1]
    if valid is None:
        f = expert_mask.mean(dim=1)
        pbar = probs.mean(dim=1)
    else:
        v = valid.float()[..., None]
        n = v.sum(dim=1).clamp(min=1.0)
        f = (expert_mask * v).sum(dim=1) / n
        pbar = (probs * v).sum(dim=1) / n
    return e * (f * pbar).sum(dim=-1)


def aux_load_balance_loss(probs: torch.Tensor, expert_mask: torch.Tensor,
                          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Switch-style load-balance loss E · Σ_e f_e · p_e; ``valid`` (T,) bool
    leaves pad tokens out of both statistics."""
    e = probs.shape[-1]
    v = None if valid is None else valid.reshape(1, -1)
    return _aux_groups(probs.reshape(1, -1, e), expert_mask.reshape(1, -1, e), v)[0]


def _capacity(n_tokens: int, cfg: ArchConfig, factor: float = 0.0) -> int:
    f = factor or cfg.capacity_factor
    c = int(math.ceil(f * n_tokens * cfg.top_k / cfg.n_experts))
    return max(cfg.top_k, min(c, n_tokens))


def _experts(p: Dict, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its buffer: (E, N, D) -> (E, N, D)."""
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _route(cfg: ArchConfig, p: Dict, x: torch.Tensor, capacity_factor: float,
           valid: Optional[torch.Tensor]):
    """The reference's routing over G groups of T tokens, x (G, T, D):
    (probs (G,T,E), gate_idx (G,T,k), gate_vals (G,T,k) renormalised and
    zero where dropped, slot_onehot (G,T,k,E) zero at pads, pos (G,T,k)
    each slot's buffer position, keep (G,T,k), real (True or (G,T,1)),
    cap)."""
    g, t, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(t, cfg, capacity_factor)
    probs = _router_probs(p, x)                                  # (G, T, E)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)           # descending
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    slot_onehot = (gate_idx[..., None] == torch.arange(e, device=x.device)).float()  # (G,T,k,E)
    eff_cap, real = cap, True           # no mask: every token is real
    if valid is not None:
        vf, real = valid.float(), valid[..., None]
        slot_onehot = slot_onehot * vf[..., None, None]
        gate_vals = gate_vals * vf[..., None]
        # The capacity formula at the valid count, in float32 as the
        # reference evaluates it: max(k, min(ceil(f·n·k/E), n)), <= cap.
        f = torch.tensor(capacity_factor or cfg.capacity_factor,
                         dtype=torch.float32, device=x.device)
        n_valid = vf.sum(dim=-1)
        eff_cap = torch.clamp(torch.minimum(torch.ceil(f * n_valid * k / e), n_valid),
                              k, cap).to(torch.int32)[:, None, None]
    flat = slot_onehot.reshape(g, t * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(g, t, k, e)
    pos = (pos_in_expert * slot_onehot).sum(dim=-1)              # (G, T, k)
    keep = pos < eff_cap
    return probs, gate_idx, gate_vals * keep, slot_onehot, pos, keep, real, cap


def _dispatch_mesh(cfg: ArchConfig, p: Dict, x: torch.Tensor, capacity_factor: float,
                   valid: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_dispatch_groups` on a mesh, by the reference's one-hot
    capacity formulation: the index dispatch's row numbers are global, so
    they cannot address a batch-sharded buffer. Routing, the one-hot
    dispatch and combine weights and each group's expert buffers run on
    each rank's groups (``batch_local``); the experts' matmuls are
    DTensor ``bmm``s with the experts sharded as their weights are (on
    "model"); the combine is a ``bmm`` whose sum over the experts' shards
    is then reduced. Same kept assignments and gates, sums in another
    order."""
    e = cfg.n_experts

    def tokens(x, valid, router):
        probs, _, gate_vals, slot_onehot, pos, keep, real, cap = _route(
            cfg, {"router": router}, x, capacity_factor, valid)
        pos_oh = (pos[..., None] == torch.arange(cap, device=x.device)).to(x.dtype)
        kept = (slot_onehot * keep[..., None]).to(x.dtype)                # (G,T,k,E)
        dispatch = torch.einsum("gtke,gtkc->gtec", kept, pos_oh).flatten(2)
        combine = torch.einsum("gtk,gtke,gtkc->gtec", gate_vals.to(x.dtype), kept,
                               pos_oh).flatten(2)                          # (G,T,E·C)
        xe = torch.bmm(dispatch.transpose(1, 2), x)                        # (G,E·C,D)
        aux = _aux_groups(probs, slot_onehot.sum(dim=2), valid)
        return xe, combine, aux, (~keep & real).sum(dim=(1, 2))

    xe, combine, aux, dropped = batch_local(tokens, (x, valid, p["router"]), (0, 0, None))
    g, cap = x.shape[0], xe.shape[1] // e
    xe = shard(xe.unflatten(1, (e, cap)).permute(1, 0, 2, 3),
               "expert", "batch", None, None)                             # (E,G,C,D)
    ye = shard(_experts(p, xe.flatten(1, 2)), "expert", "batch", None)    # (E,G·C,D)
    ye = ye.unflatten(1, (g, cap)).permute(1, 0, 2, 3).flatten(1, 2)      # (G,E·C,D)
    return shard(torch.bmm(combine, ye), "batch", None, None), aux, dropped


def _dispatch_groups(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                     capacity_factor: float = 0.0,
                     valid: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity dispatch over G independent groups of T tokens.

    x (G, T, D); valid (G, T) bool or None. Returns (out (G, T, D),
    aux (G,), dropped (G,)): ``dropped`` counts the real-token (token,
    slot) assignments the capacity struck.
    """
    if isinstance(x, DTensor):
        return _dispatch_mesh(cfg, p, x, capacity_factor, valid)
    g, t, d = x.shape
    k = cfg.top_k
    probs, gate_idx, gate_vals, slot_onehot, pos, keep, real, cap = _route(
        cfg, p, x, capacity_factor, valid)
    # Kept real slots write their token into buffer row g·cap + pos of
    # their expert; the rest write the spare last row, which no kept slot reads.
    spare = g * cap
    base = torch.arange(g, device=x.device)[:, None, None] * cap
    row = torch.where(keep & real, base + pos.long(), spare)      # (G, T, k)
    xe = x.new_zeros((cfg.n_experts, spare + 1, d))
    xe[gate_idx.reshape(-1), row.reshape(-1)] = \
        x[:, :, None, :].expand(g, t, k, d).reshape(-1, d)
    ye = _experts(p, xe)                                         # (E, G·cap + 1, D)
    out = (ye[gate_idx, row] * gate_vals[..., None]).sum(dim=2)

    aux = _aux_groups(probs, slot_onehot.sum(dim=2), valid)
    dropped = (~keep & real).sum(dim=(1, 2))
    return out, aux, dropped


def _dispatch_combine(cfg: ArchConfig, p: Dict, x2d: torch.Tensor,
                      capacity_factor: float = 0.0,
                      valid: Optional[torch.Tensor] = None,
                      return_drops: bool = False) -> Tuple[torch.Tensor, ...]:
    """Capacity-based MoE over (T, D) tokens: (out (T, D), aux loss), and the
    count of real-token assignments dropped when ``return_drops``."""
    out, aux, dropped = _dispatch_groups(
        cfg, p, x2d[None], capacity_factor,
        None if valid is None else valid[None])
    if return_drops:
        return out[0], aux[0], dropped[0]
    return out[0], aux[0]


def _shared(cfg: ArchConfig, p: Dict, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return out + apply_mlp(p["shared"], x) if cfg.n_shared_experts else out


def apply_moe_train(cfg: ArchConfig, p: Dict, x: torch.Tensor, seq_chunk: int = 512,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE over (B, S, D), one capacity group per (batch row × sequence chunk).

    Without ``mask`` the sequence is chunked only when ``S > seq_chunk`` and
    ``S % seq_chunk == 0``, else each row is one group. ``mask`` (B, S)
    bool marks real tokens of a left-padded batch (see
    :func:`_moe_train_masked`). Returns (out, aux loss).
    """
    b, s, d = x.shape
    x = shard(x, "batch", "seq", "embed")
    if mask is not None:
        out, aux = _moe_train_masked(cfg, p, x, seq_chunk, mask)
    elif s > seq_chunk and s % seq_chunk == 0:
        out, auxes, _ = _dispatch_groups(cfg, p, x.reshape(-1, seq_chunk, d))
        out, aux = out.reshape(b, s, d), _aux_mean(auxes)
    else:
        out, auxes, _ = _dispatch_groups(cfg, p, x)
        aux = _aux_mean(auxes)
    return _shared(cfg, p, x, out), aux


def _moe_train_masked(cfg: ArchConfig, p: Dict, x: torch.Tensor, seq_chunk: int,
                      mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked MoE with capacity groups of *valid-token rank*.

    Up to ``seq_chunk`` a row is one group (pads carry no weight, so their
    places change nothing). Beyond it, a stable compaction moves each row's
    real tokens to the front in order, the compacted row is padded to a
    ``seq_chunk`` multiple and chunked there, and the outputs are scattered
    back: a token's group depends only on how many real tokens precede it,
    which left padding does not change.
    """
    b, s, d = x.shape
    if s <= seq_chunk:
        out, auxes, _ = _dispatch_groups(cfg, p, x, valid=mask)
        return out, _aux_mean(auxes, mask)
    s_pad = -(-s // seq_chunk) * seq_chunk

    def compact(x, mask):
        # Unique keys (pad?, position): valid first, order kept without
        # relying on the sort's stability.
        position = torch.arange(s, device=x.device)[None, :]
        order = torch.argsort(torch.where(mask, 0, 1) * s + position, dim=1)
        xs = torch.gather(x, 1, order[..., None].expand(-1, s, d))
        ms = torch.gather(mask, 1, order)
        if s_pad != s:
            xs = F.pad(xs, (0, 0, 0, s_pad - s))
            ms = F.pad(ms, (0, s_pad - s))
        return xs, ms, torch.argsort(order, dim=1)

    def restore(out, inv):
        return torch.gather(out[:, :s], 1, inv[..., None].expand(-1, s, d))

    # Per row, so on a mesh each rank sorts its own rows (batch_local).
    xs, ms, inv = batch_local(compact, (x, mask), (0, 0))
    mc = ms.reshape(-1, seq_chunk)
    out, auxes, _ = _dispatch_groups(cfg, p, xs.reshape(-1, seq_chunk, d), valid=mc)
    return (batch_local(restore, (out.reshape(b, s_pad, d), inv), (0, 0)),
            _aux_mean(auxes, mc))


def _aux_mean(auxes: torch.Tensor, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of per-group aux losses; with a pad mask, weighted by each
    group's valid-token count (an all-pad group reports 0)."""
    if masks is None:
        return auxes.mean()
    w = masks.sum(dim=-1).float()
    return (auxes * w).sum() / w.sum().clamp(min=1.0)


# Tokens per decode dispatch chunk; the chunk's buffer is sized to its
# token count, so capacity never binds.
DECODE_CHUNK = 128

# Set to a list to record, per apply_moe_decode call, the count of real
# (token, slot) assignments dropped (one host sync per call). None: no log.
DECODE_DROP_LOG = None


def apply_moe_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                     chunk: int = DECODE_CHUNK) -> torch.Tensor:
    """Decode-path MoE for (B, 1, D) that drops nothing.

    Tokens go in chunks of ``chunk``; capacity factor E/k makes each
    chunk's capacity its token count, so even a chunk that sends every
    token to one expert keeps them all, and a token's output does not
    depend on its neighbours.
    """
    b, s, d = x.shape
    x2d = shard(x, "batch", "seq", "embed").reshape(-1, d)
    cf_full = cfg.n_experts / cfg.top_k
    outs, drops = [], []
    for lo in range(0, x2d.shape[0], chunk):
        out, _, dropped = _dispatch_groups(cfg, p, x2d[None, lo:lo + chunk],
                                           capacity_factor=cf_full)
        outs.append(out[0])
        drops.append(dropped[0])
    out = torch.cat(outs, dim=0).reshape(b, s, d)
    if DECODE_DROP_LOG is not None:
        DECODE_DROP_LOG.append(int(sum(drops)))
    return _shared(cfg, p, x, out)
