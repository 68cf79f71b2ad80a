"""The ``router_xattn`` Hopper kernel: build, bind, launch.

``csrc/router_xattn.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/repro_torch/`` at the repository root. The library's name carries
a hash of the source and flags, so an edit rebuilds. It is loaded with
``ctypes``: pointers come from ``data_ptr()`` and the stream from
PyTorch's current stream, and the kernel allocates nothing itself.

Nothing here runs at import: the CPU tests import this module on machines
without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "router_xattn.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_K = 64   # pool members: two per lane of a warp
MAX_D = 64   # router latent width: two per lane of a warp


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless this source is built already.

    Returns the library's path and nvcc's output (ptxas register and
    shared-memory report; empty when the library was already there).
    Raises if nvcc fails.
    """
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"router_xattn_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders never see half a file
    return lib, proc.stdout + proc.stderr


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
