"""Public entry points to the port's kernels.

A CUDA tensor launches the Hopper kernel (or the launch raises); a tensor
on the CPU runs the kernel's plain PyTorch version from
:mod:`repro_torch.kernels.ref`. There is no fallback from one to the
other. Nothing is padded: the reference padded d and K to 128 lanes and B
to its batch tile for the TPU, and the kernel masks its ragged edge
itself. Launches are counted on ``router_xattn.router_xattn_cuda.launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.router_xattn import router_xattn_cuda


def pool_projections(wk: torch.Tensor, wv: torch.Tensor,
                     m_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool-side K~ = m_emb Wk and V~ = m_emb Wv (fp32, (K, d)).

    Per-pool constants at serving time: computed once when the pool is
    (re)built and reused by every :func:`router_xattn_pool` call.
    """
    kt = m_emb.float() @ wk.float()
    vt = m_emb.float() @ wv.float()
    return kt.contiguous(), vt.contiguous()


def router_xattn_pool(q, wq, kt, vt, wo, bo) -> torch.Tensor:
    """Fused routing scores against precomputed pool projections: (B, K) fp32."""
    if q.is_cuda:
        return router_xattn_cuda(q, wq, kt, vt, wo, bo)
    return ref.router_xattn_pool_ref(q, wq, kt, vt, wo, bo)


def router_xattn(q, wq, wk, wv, wo, bo, m_emb) -> torch.Tensor:
    """Fused routing scores: q (B, dq), m_emb (K, dm) -> (B, K) fp32."""
    kt, vt = pool_projections(wk, wv, m_emb)
    return router_xattn_pool(q, wq, kt, vt, wo, bo)
