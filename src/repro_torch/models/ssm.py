"""Mamba-1 selective SSM block (jamba's recurrent mixer).

The port of ``repro.models.ssm``. The recurrence

    h_t = exp(dt_t · A) ⊙ h_{t-1} + dt_t · B_t · x_t,    y_t = h_t · C_t

runs over time chunks of ``SSM_CHUNK``: each chunk's decays and inputs,
(B, Q, d_inner, d_state), are formed at once, then a loop over the
chunk's steps runs the recurrence (torch has no ``associative_scan``;
the reference's log-space scan is the same recurrence, reassociated). It
runs in place unless autograd is recording, which needs every step's
state kept: then the states are new tensors, stacked, with the same
arithmetic, so a training pass differentiates what serving computes. No
more than one chunk of (B, Q, d_inner, d_state) is held at a time,
whatever the prompt length: the reference takes a prompt that is not a
multiple of the chunk as one chunk, which at jamba's width is 1 MiB per
token and row; the port's last chunk is just shorter, with the same
results within float32 rounding.

Masked compute (``mask`` (B, S) bool, True at real tokens) makes pads
identity updates: the conv input is zeroed at pads and ``dt`` -> 0 there,
so the decay is exp(0) = 1 and the input 0, and the state crosses pads
unchanged. Decode carries the (B, d_inner, d_state) state and the conv
window: O(1) per token. Both convs are sums of shifted products, as in
the reference, not ``F.conv1d``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import causal_conv, conv_step, conv_tail, dense_init
from repro_torch.models.sharding_ctx import batch_local, shard

SSM_CHUNK = 128


def init_mamba(gen: torch.Generator, cfg: ArchConfig) -> Dict:
    """The reference's layout and distributions: S4D-real A (A_log =
    log(1..d_state) per channel), a dt bias whose softplus spans
    (1e-3, 1e-1) log-uniformly, D = 1, fan-in projections, and a
    depthwise conv of standard deviation 0.1."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    ds, dc, dtr = cfg.ssm_d_state, cfg.ssm_d_conv, cfg.resolved_dt_rank
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    a_init = torch.arange(1, ds + 1, **f32)[None, :].expand(di, ds)
    u = torch.empty((di,), **f32).uniform_(0.0, 1.0, generator=gen)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    inv_softplus = dt_init + torch.log(-torch.expm1(-dt_init))
    conv_w = torch.empty((dc, di), **f32)
    return {
        "in_proj": dense_init(gen, d, 2 * di),
        "conv_w": conv_w.normal_(0.0, 0.1, generator=gen),
        "conv_b": torch.zeros((di,), **f32),
        "x_proj": dense_init(gen, di, dtr + 2 * ds),
        "dt_proj": dense_init(gen, dtr, di, scale=dtr ** 0.5),
        "dt_bias": inv_softplus,
        "A_log": torch.log(a_init),
        "D": torch.ones((di,), **f32),
        "out_proj": dense_init(gen, di, d),
    }


def _dt_b_c(cfg: ArchConfig, p: Dict, xc: torch.Tensor):
    """dt (B,S,di) = softplus(dt_proj(dt_r) + dt_bias); B, C (B,S,d_state)."""
    ds, dtr = cfg.ssm_d_state, cfg.resolved_dt_rank
    dt_r, b_mat, c_mat = (xc @ p["x_proj"]).split([dtr, ds, ds], dim=-1)
    dt = F.softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"])
    # On a mesh x_proj contracts the model-sharded d_inner, so B and C come
    # out as partial sums; the state takes them summed (the reduction GSPMD
    # inserts for the reference).
    return (dt, shard(b_mat.float(), "batch", "seq", None),
            shard(c_mat.float(), "batch", "seq", None))


def _out(p: Dict, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
         dtype) -> torch.Tensor:
    y = y + xc.float() * p["D"]
    y = shard((y * F.silu(z.float())).to(dtype), "batch", "seq", "ssm_inner")
    return y @ p["out_proj"]


def _scan(dt: torch.Tensor, xc: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
          neg_a: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over time chunks from state ``h`` (B,di,ds):
    (y (B,S,di), the last state)."""
    ys = []
    for lo in range(0, dt.shape[1], SSM_CHUNK):
        hi = lo + SSM_CHUNK
        dtc = dt[:, lo:hi]
        decay = (dtc[..., None] * neg_a).exp_()                 # (B,q,di,ds)
        # The inputs dt·B·x; the loop turns them into the states, in place
        # when serving. In place would overwrite the states autograd saved,
        # so while autograd records, each step's state is a new tensor.
        hs = (dtc * xc[:, lo:hi].float())[..., None] * b_mat[:, lo:hi, None, :]
        if hs.requires_grad or decay.requires_grad or h.requires_grad:
            states = []
            for i in range(hs.shape[1]):
                states.append(torch.addcmul(hs[:, i], decay[:, i],
                                            states[-1] if i else h))
            hs = torch.stack(states, dim=1)
        else:
            for i in range(hs.shape[1]):
                hs[:, i].addcmul_(decay[:, i], hs[:, i - 1] if i else h)
        ys.append((hs @ c_mat[:, lo:hi, :, None])[..., 0])     # (B,q,di)
        h = hs[:, -1].clone()
    return torch.cat(ys, dim=1), h


def apply_mamba_prefill(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """The prompt through one Mamba mixer: (out (B,S,d), decode state
    {h (B,di,ds), conv (B,dc-1,di)}). A left-padded row's real positions
    and final state match its unpadded run."""
    b, s, _ = x.shape
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xi = shard(xi, "batch", "seq", "ssm_inner")
    if mask is not None:
        xi = torch.where(mask[..., None], xi, 0.0)
    xc = F.silu(causal_conv(p, xi) + p["conv_b"])
    dt, b_mat, c_mat = _dt_b_c(cfg, p, xc)
    if mask is not None:
        dt = torch.where(mask[..., None], dt, 0.0)
    neg_a = -torch.exp(p["A_log"])                              # (di, ds)
    h0 = x.new_zeros((b, cfg.ssm_d_inner, cfg.ssm_d_state), dtype=torch.float32)
    # Independent per row and per channel: on a mesh each rank scans its
    # own rows and its own d_inner channels.
    y, h = batch_local(_scan, (dt, xc, b_mat, c_mat, neg_a, h0),
                       ((0, 2), (0, 2), 0, 0, (None, 0), (0, 1)),
                       out=[(0, 2), (0, 1)], inner="ssm_inner")
    out = _out(p, y, xc, z, x.dtype)
    return out, {"h": h, "conv": conv_tail(xi, cfg.ssm_d_conv)}


def apply_mamba_train(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training path: :func:`apply_mamba_prefill`'s output without its
    decode state. While autograd records, the scan keeps every step's
    state for the backward pass."""
    return apply_mamba_prefill(cfg, p, x, mask=mask)[0]


def init_mamba_cache(cfg: ArchConfig, batch: int, device) -> Dict:
    di, ds, dc = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_d_conv
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, di, ds), **f32),
            "conv": torch.zeros((batch, dc - 1, di), **f32)}


def apply_mamba_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                       cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token x (B,1,d) through one Mamba mixer; the cache's state is
    replaced by the new one."""
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xi = shard(xi, "batch", "seq", "ssm_inner")
    window = torch.cat([cache["conv"], xi], dim=1)              # (B, dc, di)
    xc = F.silu(conv_step(p, window) + p["conv_b"])
    dt, b_mat, c_mat = _dt_b_c(cfg, p, xc)                      # (B,1,·)
    decay = torch.exp(dt[:, 0, :, None] * -torch.exp(p["A_log"]))
    h = torch.addcmul((dt[:, 0] * xc[:, 0].float())[..., None] * b_mat[:, 0, None, :],
                      decay, cache["h"])
    y = (h @ c_mat[:, 0, :, None]).transpose(1, 2)              # (B,1,di)
    cache.update(h=h, conv=window[:, 1:])
    return _out(p, y, xc, z, x.dtype), cache
