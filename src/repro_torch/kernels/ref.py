"""Plain PyTorch versions of the port's kernels (the correctness oracles).

The kernel wrappers in :mod:`repro_torch.kernels.ops` run these for
tensors that lie on the CPU; the tests and ``chip_smoke.py`` hold the
CUDA kernels against them on the card.
"""
from __future__ import annotations

import math

import torch


def router_xattn_pool_ref(q, wq, kt, vt, wo, bo):
    """Routing scores against pool projections K~ = m_emb Wk, V~ = m_emb Wv.

    q (B, dq) fp32 or bf16; wq (dq, d); kt, vt (K, d); wo (d, K); bo (K,).
    Returns (B, K) fp32. The logit scale is 1/sqrt(d), d the unpadded latent.
    """
    qp = q.float() @ wq.float()                             # (B, d)
    logits = (qp @ kt.float().T) / math.sqrt(qp.shape[-1])  # (B, K)
    alpha = torch.softmax(logits, dim=-1)
    return alpha @ vt.float() @ wo.float() + bo.float()


def router_xattn_ref(q, wq, wk, wv, wo, bo, m_emb):
    """Routing scores from the raw attention params and model embeddings.

    q (B, dq); m_emb (K, dm); wq (dq, d); wk/wv (dm, d); wo (d, K); bo (K,).
    """
    kt = m_emb.float() @ wk.float()
    vt = m_emb.float() @ wv.float()
    return router_xattn_pool_ref(q, wq, kt, vt, wo, bo)
