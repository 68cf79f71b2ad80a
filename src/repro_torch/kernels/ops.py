"""Public entry points to the port's kernels.

A CUDA tensor launches the Hopper kernel (or the launch raises); a tensor
on the CPU runs the kernel's plain PyTorch version from
:mod:`repro_torch.kernels.ref`. There is no fallback from one to the
other. Nothing is padded: the reference padded d and K to 128 lanes and B
to its batch tile (``router_xattn``), and N and K to 256-row tiles
(``pairwise_l2``), for the TPU; each kernel masks its ragged edge itself.
Launches are counted on ``router_xattn.router_xattn_cuda.launches`` and
``pairwise_l2.pairwise_l2_cuda.launches``.

Profiling: :func:`set_kernel_profiler` installs a
:class:`repro_torch.obs.profiling.KernelProfiler` (or anything with a
compatible ``annotate(name, batch=...)`` context manager) around the
serving-hot entry points, ``router_xattn_pool`` and ``pairwise_l2``. With a
profiler installed, a CUDA result is synchronized inside the span (the
reference's ``jax.block_until_ready``), so the timing covers device work,
not just the launch; with none installed (the default) the call goes
straight through. The profiler changes neither which path runs nor what a
failed launch raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.pairwise_l2 import pairwise_l2_cuda
from repro_torch.kernels.router_xattn import router_xattn_cuda

# Installed profiler (None = zero-overhead pass-through).
_PROFILER = None


def set_kernel_profiler(profiler) -> None:
    """Install (or with ``None`` remove) the kernel dispatch profiler."""
    global _PROFILER
    _PROFILER = profiler


def get_kernel_profiler():
    return _PROFILER


def _ready(out: torch.Tensor) -> torch.Tensor:
    """Wait for ``out``'s device work (a CPU result is ready already)."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out


def pool_projections(wk: torch.Tensor, wv: torch.Tensor,
                     m_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool-side K~ = m_emb Wk and V~ = m_emb Wv (fp32, (K, d)).

    Per-pool constants at serving time: computed once when the pool is
    (re)built and reused by every :func:`router_xattn_pool` call.
    """
    kt = m_emb.float() @ wk.float()
    vt = m_emb.float() @ wv.float()
    return kt.contiguous(), vt.contiguous()


def _router_xattn_pool(q, wq, kt, vt, wo, bo) -> torch.Tensor:
    if q.is_cuda:
        return router_xattn_cuda(q, wq, kt, vt, wo, bo)
    return ref.router_xattn_pool_ref(q, wq, kt, vt, wo, bo)


def router_xattn_pool(q, wq, kt, vt, wo, bo) -> torch.Tensor:
    """Fused routing scores against precomputed pool projections: (B, K) fp32.

    The serving scheduler's hot path, and the one the kernel profiler sees.
    """
    if _PROFILER is None:
        return _router_xattn_pool(q, wq, kt, vt, wo, bo)
    with _PROFILER.annotate("router_xattn_pool", batch=int(q.shape[0])):
        out = _ready(_router_xattn_pool(q, wq, kt, vt, wo, bo))
    return out


def router_xattn(q, wq, wk, wv, wo, bo, m_emb) -> torch.Tensor:
    """Fused routing scores: q (B, dq), m_emb (K, dm) -> (B, K) fp32."""
    kt, vt = pool_projections(wk, wv, m_emb)
    return _router_xattn_pool(q, wq, kt, vt, wo, bo)


def _pairwise_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return pairwise_l2_cuda(x, c)
    return ref.pairwise_l2_ref(x, c)


def pairwise_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances x (N, d) vs c (K, d) -> (N, K) fp32."""
    if _PROFILER is None:
        return _pairwise_l2(x, c)
    with _PROFILER.annotate("pairwise_l2", batch=int(x.shape[0])):
        out = _ready(_pairwise_l2(x, c))
    return out
