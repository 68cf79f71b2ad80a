"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of ``repro.models.xlstm`` (xlstm-1.3b interleaves one sLSTM and
seven mLSTM blocks, arXiv:2405.04517). Forget gates are log-sigmoid,
input gates exponential with max-stabilisers, as in the reference.

  * mLSTM prefill is the reference's chunkwise-stabilised form: a loop over
    time chunks of ``MLSTM_CHUNK`` carrying (C, n, m); within a chunk a
    (Q x Q) decay-weighted quadratic term plus an inter-chunk term against
    the carried state. Decode is the one-token recurrence
    (:func:`mlstm_step`), which is also the chunkwise form's oracle.
  * sLSTM is strictly sequential (recurrent weights R·h_{t-1}): a loop over
    time with the input projections hoisted out of it, and the four
    block-diagonal recurrent matrices stacked into one (H, dh, 4·dh)
    product per step. Training runs the loop in checkpointed segments of
    ``SLSTM_SEG`` steps, as the reference's two-level scan.

Masked compute (``mask`` (B, S) bool, True at the real tokens of a
left-padded batch) makes pads identity updates of the carried state, as
in the reference: the mLSTM conv input and value stream are zeroed at
pads, with ``log_i -> NEG_INF`` and ``log_f -> 0``; the sLSTM carries its
state through a pad step unchanged. ``NEG_INF`` is finite on purpose: a
chunk of pads has m = NEG_INF and gives its pad sources weight
exp(0) = 1, which the zero value stream and the next real chunk's
``scale_old`` = exp(NEG_INF - m) = 0 wipe; with -inf that chunk gives NaN.

Decode caches are recurrent states, not KV caches: (C, n, m, conv) for an
mLSTM layer, (c, n, m, h) for an sLSTM layer. Prefill and decode replace
the state tensors in the layer's cache dict and return the dict.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import causal_conv, conv_step, conv_tail, dense_init
from repro_torch.models.sharding_ctx import batch_local, gather_tree, get_rule, merge, shard

MLSTM_CHUNK = 256
SLSTM_SEG = 64
NEG_INF = -1e30
R_KEYS = ("r_z", "r_i", "r_f", "r_o")


def prefill_width(s: int) -> int:
    """The width a prompt batch of ``s`` tokens is left-padded to for an
    mLSTM layer: ``s`` itself up to ``MLSTM_CHUNK``, else ``s`` rounded up
    to a multiple of it (the length :func:`mlstm_chunkwise` holds prefill
    to). Pads are identity updates, so real rows stay as they were."""
    return s if s <= MLSTM_CHUNK else -(-s // MLSTM_CHUNK) * MLSTM_CHUNK


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _maybe_gather(p: Dict) -> Dict:
    """ZeRO-3 gathered-weights mode (rule ``xlstm_gather_params``): keep
    the params' storage sharded but compute with replicated weights and
    fully local activations, where every consumer of the d_inner-sharded
    stream would otherwise pay an activation-sized reduction."""
    if get_rule("xlstm_gather_params"):
        return gather_tree(p)
    return p


def _blockdiag_init(gen: torch.Generator, h: int, dh: int) -> torch.Tensor:
    return torch.stack([dense_init(gen, dh, dh) for _ in range(h)])


def init_mlstm(gen: torch.Generator, cfg: ArchConfig) -> Dict:
    """The reference's layout: up-projection (d, 2·di), a depthwise conv
    of width 4, block-diagonal per-head q/k/v (H, dh, dh), input and
    forget gates (di, H) with biases -10 and 3, the skip scale and the
    down-projection (di, d)."""
    d, di, h = cfg.d_model, cfg.xlstm_d_inner, cfg.xlstm_n_heads
    dev = gen.device
    conv_w = torch.empty((4, di), dtype=torch.float32, device=dev)
    return {
        "up_proj": dense_init(gen, d, 2 * di),
        "conv_w": conv_w.normal_(0.0, 0.1, generator=gen),
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=dev),
        "wq": _blockdiag_init(gen, h, di // h),
        "wk": _blockdiag_init(gen, h, di // h),
        "wv": _blockdiag_init(gen, h, di // h),
        "w_igate": dense_init(gen, di, h),
        "b_igate": torch.full((h,), -10.0, dtype=torch.float32, device=dev),
        "w_fgate": dense_init(gen, di, h),
        "b_fgate": torch.full((h,), 3.0, dtype=torch.float32, device=dev),
        "skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "down_proj": dense_init(gen, di, d),
    }


def _mlstm_gates(p: Dict, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_i_pre, log_f) — (B,T,H) fp32; log_f = logsigmoid(f~)."""
    i_pre = (xc @ p["w_igate"]).float() + p["b_igate"]
    f_pre = (xc @ p["w_fgate"]).float() + p["b_fgate"]
    return i_pre, F.logsigmoid(f_pre)


def _mlstm_qkv(cfg: ArchConfig, p: Dict, xc: torch.Tensor, xv: torch.Tensor):
    """Block-diagonal per-head projections: (B,T,di) -> (B,T,H,dh) each;
    on a mesh on each rank's rows (``batch_local``)."""
    if isinstance(xc, DTensor):
        w = {key: p[key] for key in ("wq", "wk", "wv")}
        return batch_local(lambda w_, c, v_: _mlstm_qkv(cfg, w_, c, v_), (w, xc, xv),
                           (None, 0, 0))
    b, t, di = xc.shape
    h = cfg.xlstm_n_heads
    dh = di // h
    xh = xc.reshape(b, t, h, dh)
    q = torch.einsum("bthd,hde->bthe", xh, p["wq"])
    k = torch.einsum("bthd,hde->bthe", xh, p["wk"]) * (dh ** -0.5)
    v = torch.einsum("bthd,hde->bthe", xv.reshape(b, t, h, dh), p["wv"])
    return q, k, v


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_i: torch.Tensor, log_f: torch.Tensor,
                    state: Optional[Dict] = None, chunk: int = MLSTM_CHUNK):
    """Chunkwise-stabilised mLSTM over a sequence.

    q, k, v (B,T,H,dh); log_i, log_f (B,T,H). Returns (h (B,T,H,dh),
    final state {C (B,H,dh,dh), n (B,H,dh), m (B,H)}). T must be a multiple
    of ``min(chunk, T)``, as the reference asserts; the ``scores * w``
    products are formed before each contraction, so no (B, t, s, H, dh)
    tensor is built.
    """
    b, t, h, dh = q.shape
    qc = min(chunk, t)
    if t % qc:
        raise ValueError(
            f"mlstm_chunkwise needs the sequence length to be a multiple of its "
            f"chunk: T = {t}, chunk = {qc} (prefill pads a batch above "
            f"{MLSTM_CHUNK} tokens to a multiple of {MLSTM_CHUNK})")
    # (B,H,T,·) layout: every contraction is a batched matmul over (B, H).
    qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))
    li, lf = log_i.transpose(1, 2), log_f.transpose(1, 2)
    if state is None:
        c_in = q.new_zeros((b, h, dh, dh), dtype=torch.float32)
        n_in = q.new_zeros((b, h, dh), dtype=torch.float32)
        m_in = q.new_full((b, h), NEG_INF, dtype=torch.float32)
    else:
        c_in, n_in, m_in = state["C"], state["n"], state["m"]
    causal = torch.ones((qc, qc), dtype=torch.bool, device=q.device).tril()
    outs = []
    for lo in range(0, t, qc):
        qq, kk, vv = qh[:, :, lo:lo + qc], kh[:, :, lo:lo + qc], vh[:, :, lo:lo + qc]
        lic, lfc = li[:, :, lo:lo + qc], lf[:, :, lo:lo + qc]
        # Cumulative log decay within the chunk: F[t] = sum_{s<=t} lf[s].
        fcum = lfc.cumsum(dim=-1)                                   # (B,H,t)
        # Log weight of in-chunk source s at target t (s <= t):
        #   li[s] + F[t] - F[s].
        log_w = (lic - fcum)[..., None, :] + fcum[..., :, None]     # (B,H,t,s)
        log_w = log_w.masked_fill(~causal, NEG_INF)
        # Log weight of the carried state at target t: m_in + F[t].
        log_carry = m_in[..., None] + fcum                          # (B,H,t)
        m_t = torch.maximum(log_w.amax(dim=-1), log_carry)
        w = torch.exp(log_w - m_t[..., None])
        carry_scale = torch.exp(log_carry - m_t)
        sw = (qq @ kk.transpose(-1, -2)) * w                        # scores * w
        # C[d, e] = k[d] v[e]: q contracts with the key index d.
        num = sw @ vv + (qq @ c_in) * carry_scale[..., None]
        den = sw.sum(dim=-1) + (qq @ n_in[..., None])[..., 0] * carry_scale
        outs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])

        # Carry update to the end of the chunk.
        f_total = fcum[..., -1]                                     # (B,H)
        log_src = lic + (f_total[..., None] - fcum)                 # (B,H,s)
        m_out = torch.maximum(m_in + f_total, log_src.amax(dim=-1))
        w_src = torch.exp(log_src - m_out[..., None])
        scale_old = torch.exp(m_in + f_total - m_out)
        kw = kk * w_src[..., None]                                  # kk * w_src
        c_in = c_in * scale_old[..., None, None] + kw.transpose(-1, -2) @ vv
        n_in = n_in * scale_old[..., None] + kw.sum(dim=-2)
        m_in = m_out
    h_out = torch.cat(outs, dim=2).transpose(1, 2)
    return h_out, {"C": c_in, "n": n_in, "m": m_in}


def mlstm_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_i: torch.Tensor, log_f: torch.Tensor, state: Dict):
    """One-token recurrence (decode, and the oracle of the chunkwise form).

    q, k, v (B,H,dh); log_i, log_f (B,H). Returns (h (B,H,dh), new state);
    ``state`` is not modified.
    """
    c_in, n_in, m_in = state["C"], state["n"], state["m"]
    b, h, dh = q.shape
    m_t = torch.maximum(log_f + m_in, log_i)
    f_s = torch.exp(log_f + m_in - m_t)
    i_s = torch.exp(log_i - m_t)
    # C_t = f_s·C + i_s·(k ⊗ v): one rescale, then a rank-1 update in place.
    c_t = c_in * f_s[..., None, None]
    c_t.view(b * h, dh, dh).baddbmm_((i_s[..., None] * k).reshape(b * h, dh, 1),
                                     v.reshape(b * h, 1, dh))
    n_t = n_in * f_s[..., None] + i_s[..., None] * k
    num = (q[..., None, :] @ c_t)[..., 0, :]
    den = (n_t * q).sum(dim=-1)
    h_t = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    return h_t, {"C": c_t, "n": n_t, "m": m_t}


def _mlstm_front(p: Dict, x: torch.Tensor, conv_state: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None):
    """Up-projection and causal conv: (xc, xv, z, new conv state or None).

    ``mask`` zeroes pad inputs before the conv, so the window over leading
    pads matches the zero front padding an unpadded run sees, and the
    value stream ``xv`` is exactly zero at pads.
    """
    xi, z = (x @ p["up_proj"]).chunk(2, dim=-1)
    if mask is not None:
        xi = torch.where(mask[..., None], xi, 0.0)
    if not get_rule("xlstm_gather_params"):
        xi = shard(xi, "batch", "seq", "ssm_inner")
    if conv_state is not None:
        window = torch.cat([conv_state, xi], dim=1)             # (B, dc, di)
        xc = F.silu(conv_step(p, window) + p["conv_b"])
        return xc, xi, z, window[:, 1:]
    return F.silu(causal_conv(p, xi) + p["conv_b"]), xi, z, None


def apply_mlstm_prefill(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                        mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """The prompt through one mLSTM mixer: (out (B,T,d), decode state
    {C, n, m, conv}). Pad steps contribute nothing to the recurrence; real
    positions and the final state match the row's unpadded run."""
    p = _maybe_gather(p)
    b, t, _ = x.shape
    xc, xv, z, _ = _mlstm_front(p, x, mask=mask)
    q, k, v = _mlstm_qkv(cfg, p, xc, xv)
    log_i, log_f = _mlstm_gates(p, xc)
    if mask is not None:
        log_i = torch.where(mask[..., None], log_i, NEG_INF)
        log_f = torch.where(mask[..., None], log_f, 0.0)
    h, state = batch_local(mlstm_chunkwise, (q, k, v, log_i, log_f), (0,) * 5)
    h = merge(h, 2).to(x.dtype) + p["skip"] * xc
    out = (h * F.silu(z)) @ p["down_proj"]
    return out, {**state, "conv": conv_tail(xv, p["conv_w"].shape[0])}


def apply_mlstm_train(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training path: :func:`apply_mlstm_prefill`'s output without its
    decode state."""
    return apply_mlstm_prefill(cfg, p, x, mask=mask)[0]


def init_mlstm_cache(cfg: ArchConfig, batch: int, device) -> Dict:
    di, h = cfg.xlstm_d_inner, cfg.xlstm_n_heads
    dh = di // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, h, dh, dh), **f32),
        "n": torch.zeros((batch, h, dh), **f32),
        "m": torch.full((batch, h), NEG_INF, **f32),
        "conv": torch.zeros((batch, 3, di), **f32),
    }


def apply_mlstm_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                       cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token x (B,1,d) through one mLSTM mixer; the cache's state is
    replaced by the new one."""
    p = _maybe_gather(p)
    b = x.shape[0]
    xc, xv, z, conv_state = _mlstm_front(p, x, cache["conv"])
    q, k, v = _mlstm_qkv(cfg, p, xc, xv)
    log_i, log_f = _mlstm_gates(p, xc)
    h, state = batch_local(mlstm_step, (q[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                                        log_i[:, 0], log_f[:, 0],
                                        {key: cache[key] for key in "Cnm"}), (0,) * 6)
    h = merge(h, 1)[:, None].to(x.dtype) + p["skip"] * xc
    out = (h * F.silu(z)) @ p["down_proj"]
    cache.update(state, conv=conv_state)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ArchConfig) -> Dict:
    """Input projections (d, 4·d) for z, i, f, o; four block-diagonal
    recurrent matrices (H, dh, dh) of N(0, 1/dh); biases 0, -5, 3, 0; and a
    gated GELU FFN whose width is ``ff_factor · d`` rounded up to 256."""
    d, h = cfg.d_model, cfg.xlstm_n_heads
    dh = d // h
    dev = gen.device
    f_ff = -(-int(cfg.xlstm_ff_factor * d) // 256) * 256
    p = {"w": dense_init(gen, d, 4 * d)}
    for key in R_KEYS:
        r = torch.empty((h, dh, dh), dtype=torch.float32, device=dev)
        p[key] = r.normal_(0.0, 1.0, generator=gen).div_(dh ** 0.5)
    p["b"] = torch.cat([torch.full((d,), v, dtype=torch.float32, device=dev)
                        for v in (0.0, -5.0, 3.0, 0.0)])
    p["ff_up"] = dense_init(gen, d, 2 * f_ff)
    p["ff_down"] = dense_init(gen, f_ff, d)
    return p


def _slstm_cell(pre: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                m: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One sLSTM step on per-head (H, B, dh) tensors. ``pre`` (H, B, 4·dh)
    holds W·x_t + b + R·h_{t-1}, gates z, i, f, o in that order. Returns
    the new (c, n, m, h)."""
    z_pre, i_log, f_pre, o_pre = pre.chunk(4, dim=-1)
    z = torch.tanh(z_pre)
    f_m = F.logsigmoid(f_pre) + m
    o = torch.sigmoid(o_pre)
    m_t = torch.maximum(f_m, i_log)
    i_s = torch.exp(i_log - m_t)
    f_s = torch.exp(f_m - m_t)
    c_t = torch.addcmul(f_s * c, i_s, z)
    n_t = torch.addcmul(i_s, f_s, n)
    h_t = o * c_t / torch.clamp(n_t, min=1e-6)
    return c_t, n_t, m_t, h_t


def _wx_heads(wx: torch.Tensor, nh: int) -> torch.Tensor:
    """W·x + b, (B, T, 4·d) gate-major, -> (T, H, B, 4·dh): per head the
    four gates' dh columns side by side, as the stacked R gives them."""
    b, t, four_d = wx.shape
    dh = four_d // 4 // nh
    return wx.reshape(b, t, 4, nh, dh).permute(1, 3, 0, 2, 4).reshape(t, nh, b, 4 * dh)


def _state_heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """(B, d) -> (H, B, dh)."""
    b, d = x.shape
    return x.reshape(b, nh, d // nh).transpose(0, 1)


def _state_rows(x: torch.Tensor) -> torch.Tensor:
    """(H, B, dh) -> (B, d)."""
    h, b, dh = x.shape
    return x.transpose(0, 1).reshape(b, h * dh)


def init_slstm_cache(cfg: ArchConfig, batch: int, device) -> Dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32), "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), NEG_INF, **f32),
            "h": torch.zeros((batch, d), **f32)}


def _slstm_ffn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Gated FFN; ``jax.nn.gelu`` is the tanh approximation by default."""
    a, g = (x @ p["ff_up"]).chunk(2, dim=-1)
    return (F.gelu(a, approximate="tanh") * g) @ p["ff_down"]


def _slstm_steps(wx: torch.Tensor, r: torch.Tensor, cnmh: torch.Tensor,
                 keep: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sLSTM over W·x + b (T, H, B, 4·dh) from the stacked state
    (c, n, m, h) (4, H, B, dh); ``keep`` (T, 1, 1, B, 1) or None. Returns
    (the final stacked state, h at every step (T, H, B, dh))."""
    hs = []
    for i in range(wx.shape[0]):
        new = torch.stack(_slstm_cell(torch.baddbmm(wx[i], cnmh[3], r), *cnmh[:3]))
        cnmh = new if keep is None else torch.where(keep[i], new, cnmh)
        hs.append(cnmh[3])
    return cnmh, torch.stack(hs)


def _slstm_rows(wx, r, cnmh, keep):
    """:func:`_slstm_steps`, on a mesh on each rank's batch rows
    (``batch_local``; the batch is dim 2 of the stacked inputs)."""
    return batch_local(_slstm_steps, (wx, r, cnmh, keep), (2, None, 2, 3), out=2)


def _slstm_run(cfg: ArchConfig, p: Dict, x: torch.Tensor, mask: Optional[torch.Tensor],
               segments: bool) -> Tuple[torch.Tensor, Dict]:
    """(out (B,T,d), final state) of one sLSTM mixer. With ``segments``, a
    sequence of ``T % SLSTM_SEG == 0`` and ``T > SLSTM_SEG`` runs each
    segment under ``torch.utils.checkpoint``, the reference's two-level
    scan: autograd keeps the carries only at segment boundaries and
    recomputes the steps within a segment."""
    p = _maybe_gather(p)
    b, t, d = x.shape
    nh = cfg.xlstm_n_heads
    wx = _wx_heads(x @ p["w"] + p["b"], nh)                 # hoisted: (T,H,B,4dh)
    r = torch.cat([p[key] for key in R_KEYS], dim=-1)       # (H, dh, 4·dh)
    state = init_slstm_cache(cfg, b, x.device)
    # (c, n, m, h) stacked: one select per step carries a pad step through.
    cnmh = torch.stack([_state_heads(state[key], nh) for key in "cnmh"])
    keep = None if mask is None else mask.t()[:, None, None, :, None]  # (T,1,1,B,1)
    if segments and t % SLSTM_SEG == 0 and t > SLSTM_SEG:
        hs = []
        for lo in range(0, t, SLSTM_SEG):
            seg = slice(lo, lo + SLSTM_SEG)
            cnmh, h = checkpoint(_slstm_rows, wx[seg], r, cnmh,
                                 None if keep is None else keep[seg], use_reentrant=False)
            hs.append(h)
        h_seq = torch.cat(hs)
    else:
        cnmh, h_seq = _slstm_rows(wx, r, cnmh, keep)
    out = _slstm_ffn(p, merge(h_seq.permute(2, 0, 1, 3), 2).to(x.dtype))
    return out, {key: _state_rows(s) for key, s in zip("cnmh", cnmh)}


def apply_slstm_prefill(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                        mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """The prompt through one sLSTM mixer: (out (B,T,d), decode state
    {c, n, m, h}). At a pad step the cell state is carried through
    unchanged, so a row's real trajectory is its unpadded run's."""
    return _slstm_run(cfg, p, x, mask, segments=False)


def apply_slstm_train(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training path: the prefill's steps, in checkpointed segments of
    ``SLSTM_SEG`` when the length allows (:func:`_slstm_run`)."""
    return _slstm_run(cfg, p, x, mask, segments=True)[0]


def apply_slstm_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                       cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token x (B,1,d) through one sLSTM mixer; the cache's state is
    replaced by the new one. The four recurrent products run apart (no
    per-step copy of the stacked R)."""
    p = _maybe_gather(p)
    nh = cfg.xlstm_n_heads
    wx = _wx_heads(x @ p["w"] + p["b"], nh)[0]              # (H, B, 4·dh)
    c, n, m, h = (_state_heads(cache[key], nh) for key in "cnmh")
    rec = torch.cat([torch.bmm(h, p[key]) for key in R_KEYS], dim=-1)
    new = _slstm_cell(wx + rec, c, n, m)
    cache.update({key: _state_rows(s) for key, s in zip("cnmh", new)})
    return _slstm_ffn(p, cache["h"][:, None].to(x.dtype)), cache
