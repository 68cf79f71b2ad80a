"""Build a kernel source with ``nvcc`` into a plain-C shared library.

Each ``csrc/<name>.cu`` is compiled for ``sm_90a`` at first use into
``build/repro_torch/`` at the repository root. The library's name carries
a hash of the source, the headers beside it and the flags, so an edit
rebuilds. The kernel modules load it with ``ctypes``: pointers come from
``data_ptr()`` and the stream from PyTorch's current stream, and no
kernel allocates anything itself.

Nothing here runs at import: the CPU tests import the kernel modules on
machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def launch(entry, device: torch.device, *args) -> int:
    """Call the C entry point ``entry(*args, stream)`` on PyTorch's current
    stream of ``device`` and return its error code. The device's context is
    entered only when it is not the current device, and the stream's raw
    handle comes from the private accessor, which builds no
    ``torch.cuda.Stream`` object: both save host time on every launch."""
    index = device.index
    if index == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless this source is built already.

    Returns the library's path and nvcc's output (ptxas register, spill
    and shared-memory report), which is kept beside the library as
    ``<name>.log`` and read back when the library was already built.
    Raises if nvcc fails.
    """
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):   # a header edit rebuilds too
        digest.update(header.read_bytes())
    lib = BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"
    report = lib.with_suffix(".log")
    if lib.exists():
        return lib, report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stdout}{proc.stderr}")
    report.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)   # atomic: a concurrent build never sees half a file
    return lib, proc.stdout + proc.stderr
