"""The ``pairwise_l2`` Hopper kernel: build, bind, launch.

``csrc/pairwise_l2.cu`` is compiled by :func:`repro_torch.kernels.build.build`
into ``build/repro_torch/pairwise_l2_<hash>.so`` at first use and loaded
with ``ctypes``. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build as kbuild

SOURCE = kbuild.CSRC / "pairwise_l2.cu"
TILE = 64            # output rows and columns per block
MAX_GRID_Y = 65535   # CUDA's limit on gridDim.y, which walks N


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless built already: (path, nvcc output)."""
    return kbuild.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pairwise_l2_launch.argtypes = [p, i, p, i, p, i, i, i, p]
    lib.pairwise_l2_launch.restype = i
    lib.pairwise_l2_error_string.argtypes = [i]
    lib.pairwise_l2_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, c: torch.Tensor) -> Tuple[int, int, int]:
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"pairwise_l2 wants x (N, d) and c (K, d); got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    for name, t in (("x", x), ("c", c)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"pairwise_l2: {name} is on {t.device}; both "
                             f"operands must be on x's CUDA device {x.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"pairwise_l2: {name} must be float32 or bfloat16, "
                            f"not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"pairwise_l2: {name} must be contiguous")
    n, d = x.shape
    k = c.shape[0]
    if -(-n // TILE) > MAX_GRID_Y:
        raise ValueError(f"pairwise_l2 kernel takes N <= {MAX_GRID_Y * TILE}; got {n}")
    return n, k, d


def pairwise_l2_cuda(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (N, K) fp32 squared distances on x's device.

    ``pairwise_l2_cuda.launches`` counts the launches made.
    """
    n, k, d = _check(x, c)
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0 or k == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.pairwise_l2_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), c.data_ptr(),
            int(c.dtype == torch.bfloat16), out.data_ptr(), n, k, d,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("pairwise_l2 launch failed: "
                           + lib.pairwise_l2_error_string(err).decode())
    pairwise_l2_cuda.launches += 1
    return out


pairwise_l2_cuda.launches = 0
