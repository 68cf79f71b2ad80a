"""The ``pairwise_l2`` Hopper kernel: plan, build, bind, launch.

``csrc/pairwise_l2.cu`` is compiled by :func:`repro_torch.kernels.build.build`
into ``build/repro_torch/pairwise_l2_<hash>.so`` at first use and loaded
with ``ctypes``. :func:`plan` is pure Python: it fixes the launch (cluster
size, grid, shared bytes) from the shapes alone, so the CPU tests check it.
Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build as kbuild

SOURCE = kbuild.CSRC / "pairwise_l2.cu"
TILE = 64            # output rows and columns per block
SLICE = 32           # features staged per step
MAX_CLUSTER = 8      # the portable thread-block cluster size
SMS = 132            # streaming multiprocessors of an H100 SXM: one wave
MAX_GRID_Y = 65535   # CUDA's limit on gridDim.y, which walks the N tiles
MAX_INT = 2**31 - 1  # N, K and d reach the kernel as C ints; gridDim.x's limit
THREADS = 256
PITCH = 36           # floats per staged row of a slice
SMEM = 4 * (2 * 2 * TILE * PITCH + 2 * TILE)  # static: two buffers of x and c slices, norms


class Plan(NamedTuple):
    """One launch: ``grid`` = (x, y) blocks in clusters of ``cluster`` along x.

    x walks the K tiles, ``cluster`` blocks each; y walks the N tiles. Rank
    s of a cluster walks the slices [s * spr, (s + 1) * spr) of 32 features;
    ``smem`` is each block's shared bytes.
    """
    cluster: int
    spr: int
    grid: Tuple[int, int]
    threads: int
    smem: int


@functools.lru_cache(maxsize=256)
def plan(n: int, k: int, d: int) -> Plan:
    """Split d over the ranks of a cluster so that tiles x S is about one
    wave: S = min(8, ceil(d / 32), 132 // tiles), at least 1, then trimmed
    so every rank gets slices. Raises on shapes the grid cannot take."""
    tiles_n, tiles_k = -(-n // TILE), -(-k // TILE)
    if not (1 <= n <= MAX_GRID_Y * TILE and 1 <= k <= MAX_INT and 0 <= d <= MAX_INT):
        raise ValueError(f"pairwise_l2 kernel takes 1 <= N <= {MAX_GRID_Y * TILE}, "
                         f"1 <= K <= {MAX_INT} and d <= {MAX_INT}; got N={n}, K={k}, "
                         f"d={d}")
    slices = max(1, -(-d // SLICE))   # d = 0: one empty slice, distances 0
    want = max(1, min(MAX_CLUSTER, slices, SMS // (tiles_n * tiles_k)))
    spr = -(-slices // want)
    cluster = -(-slices // spr)
    return Plan(cluster=cluster, spr=spr, grid=(cluster * tiles_k, tiles_n),
                threads=THREADS, smem=SMEM)


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless built already: (path, nvcc output)."""
    return kbuild.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pairwise_l2_launch.argtypes = [p, i, p, i, p, i, i, i, i, i, p]
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
    return n, c.shape[0], d


def pairwise_l2_cuda(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (N, K) fp32 squared distances on x's device.

    ``pairwise_l2_cuda.launches`` counts the launches made.
    """
    n, k, d = _check(x, c)
    if n == 0 or k == 0:
        return torch.empty((n, k), dtype=torch.float32, device=x.device)
    pl = plan(n, k, d)
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    lib = _library()
    args = (x.data_ptr(), int(x.dtype == torch.bfloat16), c.data_ptr(),
            int(c.dtype == torch.bfloat16), out.data_ptr(), n, k, d, pl.cluster, pl.spr)
    err = kbuild.launch(lib.pairwise_l2_launch, x.device, *args)
    if err != 0:
        raise RuntimeError("pairwise_l2 launch failed: "
                           + lib.pairwise_l2_error_string(err).decode())
    pairwise_l2_cuda.launches += 1
    return out


pairwise_l2_cuda.launches = 0
