"""The ``router_xattn`` Hopper kernel: build, bind, launch.

``csrc/router_xattn.cu`` is compiled by :func:`repro_torch.kernels.build.build`
into ``build/repro_torch/router_xattn_<hash>.so`` at first use and loaded
with ``ctypes``. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build as kbuild

SOURCE = kbuild.CSRC / "router_xattn.cu"
MAX_K = 64   # pool members: two per lane of a warp
MAX_D = 64   # router latent width: two per lane of a warp


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless built already: (path, nvcc output)."""
    return kbuild.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.router_xattn_launch.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i,
                                        ctypes.c_float, p]
    lib.router_xattn_launch.restype = i
    lib.router_xattn_error_string.argtypes = [i]
    lib.router_xattn_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, wq, kt, vt, wo, bo) -> Tuple[int, int, int, int]:
    if q.dim() != 2 or wq.dim() != 2 or kt.dim() != 2:
        raise ValueError("router_xattn wants q (B, dq), wq (dq, d), kt (K, d)")
    b, dq = q.shape
    k, d = kt.shape
    shapes = {"wq": (wq, (dq, d)), "kt": (kt, (k, d)), "vt": (vt, (k, d)),
              "wo": (wo, (d, k)), "bo": (bo, (k,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"router_xattn: {name} has shape {tuple(t.shape)}, "
                             f"want {want}")
    if not (1 <= k <= MAX_K and 1 <= d <= MAX_D and dq >= 1):
        raise ValueError(f"router_xattn kernel takes 1 <= K <= {MAX_K} and "
                         f"1 <= d <= {MAX_D}; got K={k}, d={d}, dq={dq}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"router_xattn: q must be float32 or bfloat16, not {q.dtype}")
    for name, t in [("q", q)] + [(n, t) for n, (t, _) in shapes.items()]:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"router_xattn: {name} is on {t.device}; every "
                             f"operand must be on q's CUDA device {q.device}")
        if name != "q" and t.dtype != torch.float32:
            raise TypeError(f"router_xattn: {name} must be float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"router_xattn: {name} must be contiguous")
    return b, dq, k, d


def router_xattn_cuda(q, wq, kt, vt, wo, bo) -> torch.Tensor:
    """Launch the kernel: (B, K) fp32 routing scores on q's device.

    ``router_xattn_cuda.launches`` counts the launches made.
    """
    b, dq, k, d = _check(q, wq, kt, vt, wo, bo)
    out = torch.empty((b, k), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.router_xattn_launch(
            q.data_ptr(), int(q.dtype == torch.bfloat16), wq.data_ptr(),
            kt.data_ptr(), vt.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            out.data_ptr(), b, dq, d, k, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("router_xattn launch failed: "
                           + lib.router_xattn_error_string(err).decode())
    router_xattn_cuda.launches += 1
    return out


router_xattn_cuda.launches = 0
