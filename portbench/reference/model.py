"""Plain forward passes of the pool's decoders, one sequence at a time.

A member is described by its entry in the benchmark's config file; the
weights are the tree the benchmark made (``embedding/table``, ``head``,
``final_norm``, ``layers[i]`` with ``norm1``, ``mixer`` and ``norm2``,
``ffn``). Pre-norm blocks: RMSNorm (eps ``norm_eps``), grouped-query
causal attention with half-split RoPE (and RMSNorm over each head's q and
k with ``qk_norm``), then a SwiGLU MLP or a mixture of experts.

The mixture of experts follows the configuration's capacity rule: the
router's softmax in float32, the top ``top_k`` experts with their gates
renormalised, and within one capacity group a (token, slot) assignment is
kept while fewer than ``cap`` earlier assignments (token-major,
slot-minor) went to its expert, with ``cap = min(max(k, min(ceil(f·n·k/E),
n)), max(k, min(ceil(f·T·k/E), T)))`` for ``n`` real tokens of a group of
width ``T`` and capacity factor ``f``. A served prompt is one group (its
prompt's width is at most 512); decoded tokens are never dropped. A
training row's real tokens are cut into groups of 512 in order.

``prec`` is the matmul precision: ``fp32`` (TF32 off), ``tf32`` (the
card's TF32 matmuls, set by :func:`precision`) or ``bf16`` (operands
rounded to bfloat16, products summed in float32).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

GROUP = 512


@contextlib.contextmanager
def precision(prec: str):
    """TF32 on for ``tf32``, off otherwise, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = prec == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "bf16":
        return (a.bfloat16() @ b.bfloat16()).float()
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) rotated by positions (T,), halves (not interleaved)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def attention(m: Dict, p: Dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    t = x.shape[0]
    h, hkv, hd = m["n_heads"], m["n_kv_heads"], head_dim(m)
    q = mm(x, p["wq"], prec).view(t, h, hd)
    k = mm(x, p["wk"], prec).view(t, hkv, hd)
    v = mm(x, p["wv"], prec).view(t, hkv, hd)
    if m.get("qk_norm"):
        q = rmsnorm(q, p["q_norm"]["scale"], m["norm_eps"])
        k = rmsnorm(k, p["k_norm"]["scale"], m["norm_eps"])
    pos = torch.arange(t, device=x.device)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    scores = mm(q.transpose(0, 1), k.permute(1, 2, 0), prec) / math.sqrt(hd)   # (H, T, T)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = mm(probs, v.transpose(0, 1), prec).transpose(0, 1).reshape(t, h * hd)
    return mm(out, p["wo"], prec)


def mlp(p: Dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    return mm(F.silu(mm(x, p["w_gate"], prec)) * mm(x, p["w_up"], prec), p["w_down"], prec)


def capacity(m: Dict, n: int, width: int) -> int:
    """Kept assignments per expert in a group of ``n`` real tokens out of
    ``width``."""
    f, k, e = m["capacity_factor"], m["top_k"], m["n_experts"]

    def rule(t: int) -> int:
        return max(k, min(int(math.ceil(f * t * k / e)), t))

    return min(rule(n), rule(width))


def moe(m: Dict, p: Dict, x: torch.Tensor, cap: Optional[int], prec: str
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, load-balance aux) of one group x (T, D); ``cap`` None keeps
    every assignment. The aux is E · Σ_e f_e · p̄_e over the group's
    tokens, f counting every routed assignment, kept or not."""
    e, k = m["n_experts"], m["top_k"]
    probs = torch.softmax(mm(x, p["router"], prec).float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = F.one_hot(idx, e).float()                                 # (T, k, E)
    keep = torch.ones_like(gates, dtype=torch.bool)
    if cap is not None:
        flat = onehot.reshape(-1, e)
        pos = ((flat.cumsum(0) - flat).reshape(onehot.shape) * onehot).sum(-1)
        keep = pos < cap
    out = torch.zeros_like(x)
    for j in range(e):
        tok, slot = torch.nonzero((idx == j) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(mm(xe, p["w_gate"][j], prec)) * mm(xe, p["w_up"][j], prec)
        out = out.index_add(0, tok, mm(h, p["w_down"][j], prec) * gates[tok, slot, None])
    aux = e * (onehot.sum(1).mean(0) * probs.mean(0)).sum()
    return out, aux


def _blocks(m: Dict, params: Dict, x: torch.Tensor, prec: str, ffn_moe) -> torch.Tensor:
    for p in params["layers"]:
        x = x + attention(m, p["mixer"], rmsnorm(x, p["norm1"]["scale"], m["norm_eps"]), prec)
        h = rmsnorm(x, p["norm2"]["scale"], m["norm_eps"])
        x = x + (ffn_moe(p["ffn"], h) if m.get("n_experts") else mlp(p["ffn"], h, prec))
    return rmsnorm(x, params["final_norm"]["scale"], m["norm_eps"])


def served_logits(m: Dict, params: Dict, tokens: torch.Tensor, n_prompt: int,
                  prec: str = "fp32") -> torch.Tensor:
    """Logits (T, vocab) of one served sequence, ``tokens`` its prompt of
    ``n_prompt`` then the generated tokens: the prompt is one capacity
    group, the rest drops nothing."""
    def ffn_moe(p, h):
        cap = capacity(m, n_prompt, n_prompt)
        y0 = moe(m, p, h[:n_prompt], cap, prec)[0]
        if h.shape[0] == n_prompt:
            return y0
        return torch.cat([y0, moe(m, p, h[n_prompt:], None, prec)[0]])

    with torch.no_grad():
        x = params["embedding"]["table"][tokens.long()]
        x = _blocks(m, params, x, prec, ffn_moe)
        return mm(x, params["embedding"]["head"], prec)[:, : m["vocab_size"]]


def train_row(m: Dict, params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
              prec: str = "fp32") -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, int]]]:
    """(summed cross entropy, [(aux, real tokens) per capacity group and
    layer]) of one training row's real tokens."""
    groups: List[Tuple[torch.Tensor, int]] = []

    def ffn_moe(p, h):
        outs = []
        for lo in range(0, h.shape[0], GROUP):
            hg = h[lo:lo + GROUP]
            y, aux = moe(m, p, hg, capacity(m, hg.shape[0], GROUP), prec)
            outs.append(y)
            groups.append((aux, hg.shape[0]))
        return torch.cat(outs)

    x = params["embedding"]["table"][tokens.long()]
    x = _blocks(m, params, x, prec, ffn_moe)
    logits = mm(x, params["embedding"]["head"], prec)[:, : m["vocab_size"]]
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(1, labels.long()[:, None])[:, 0]
    return ce.sum(), groups
