"""The ``router_xattn`` Hopper kernel: plan, build, bind, launch.

``csrc/router_xattn.cu`` is compiled by :func:`repro_torch.kernels.build.build`
into ``build/repro_torch/router_xattn_<hash>.so`` at first use and loaded
with ``ctypes``. :func:`plan` is pure Python: it fixes the launch (cluster
size, grid, shared bytes) from the shapes alone, so the CPU tests check it.
Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build as kbuild

SOURCE = kbuild.CSRC / "router_xattn.cu"
MAX_K = 64         # pool members: two per lane of a warp
MAX_D = 64         # router latent width: two per lane of a warp
MAX_CLUSTER = 8    # the portable thread-block cluster size
ROWS = 4           # query rows per tile: one warp each in the epilogue
TILE = 32          # Wq rows summed apart before their sums are added
MAX_CHUNK = 256    # Wq rows a block stages at once (<= 137 KB of shared memory)


class Plan(NamedTuple):
    """One launch: ``grid`` blocks of ``threads`` in clusters of ``cluster``.

    Rank s of a cluster walks Wq rows [s * slice, min(dq, (s + 1) * slice))
    in chunks of at most ``chunk`` rows; ``smem`` is the dynamic shared
    bytes of every block.
    """
    cluster: int
    rows: int
    slice: int
    chunk: int
    grid: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=256)
def plan(b: int, dq: int, d: int, k: int) -> Plan:
    """Split dq = ceil(dq / 32) tiles of 32 rows over at most 8 cluster ranks.

    Every rank but the last gets the same whole number of tiles, so no rank
    idles and the 32-row tiles of the blocked sum stay where they were.
    """
    tiles = -(-dq // TILE)
    per_rank = -(-tiles // min(MAX_CLUSTER, tiles))
    cluster = -(-tiles // per_rank)
    slice_rows = TILE * per_rank
    chunk = min(slice_rows, MAX_CHUNK)
    floats = (chunk * d + ROWS * (chunk + 1) + chunk // TILE * ROWS * d + ROWS * d
              + 3 * d * k + k + ROWS * 64 + (cluster - 1) * ROWS * d)
    return Plan(cluster=cluster, rows=ROWS, slice=slice_rows, chunk=chunk,
                grid=cluster * -(-b // ROWS), threads=32 * ROWS, smem=4 * floats)


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless built already: (path, nvcc output)."""
    return kbuild.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.router_xattn_launch.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i,
                                        ctypes.c_float, i, i, i, i, i, p]
    lib.router_xattn_launch.restype = i
    lib.router_xattn_error_string.argtypes = [i]
    lib.router_xattn_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, wq, kt, vt, wo, bo) -> Tuple[int, int, int, int]:
    """One pass over the operands: shape, device, dtype, contiguity."""
    if q.dim() != 2 or kt.dim() != 2:
        raise ValueError("router_xattn wants q (B, dq), wq (dq, d), kt (K, d)")
    b, dq = q.shape
    k, d = kt.shape
    if not (1 <= k <= MAX_K and 1 <= d <= MAX_D and dq >= 1):
        raise ValueError(f"router_xattn kernel takes 1 <= K <= {MAX_K} and "
                         f"1 <= d <= {MAX_D}; got K={k}, d={d}, dq={dq}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"router_xattn: q must be float32 or bfloat16, not {q.dtype}")
    dev = q.device
    for name, t, want in (("q", q, (b, dq)), ("wq", wq, (dq, d)), ("kt", kt, (k, d)),
                          ("vt", vt, (k, d)), ("wo", wo, (d, k)), ("bo", bo, (k,))):
        if t.shape != want:
            raise ValueError(f"router_xattn: {name} has shape {tuple(t.shape)}, "
                             f"want {want}")
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"router_xattn: {name} is on {t.device}; every "
                             f"operand must be on q's CUDA device {dev}")
        if t is not q and t.dtype != torch.float32:
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
    pl = plan(b, dq, d, k)
    args = (q.data_ptr(), int(q.dtype == torch.bfloat16), wq.data_ptr(), kt.data_ptr(),
            vt.data_ptr(), wo.data_ptr(), bo.data_ptr(), out.data_ptr(), b, dq, d, k,
            1.0 / math.sqrt(d), pl.cluster, pl.rows, pl.slice, pl.chunk, pl.smem)
    err = kbuild.launch(lib.router_xattn_launch, q.device, *args)
    if err != 0:
        raise RuntimeError("router_xattn launch failed: "
                           + lib.router_xattn_error_string(err).decode())
    router_xattn_cuda.launches += 1
    return out


router_xattn_cuda.launches = 0
