"""Device meshes and the H100's per-card constants.

The port of ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims: ``("data",
"model")``, or ``("pod", "data", "model")`` for two pods.

  * :func:`make_debug_mesh` builds a small mesh of real devices. With no
    process group it starts one of world size 1 (NCCL on the card, gloo
    on the CPU); with one, its world size must be the mesh's.
  * :func:`make_production_mesh` builds the reference's 16x16 (or
    2x16x16) mesh in one process, over torch's fake process group: its
    collectives move nothing, so the dry-run traces a step as rank 0 of
    256 (or 512) without the hardware, as the reference lowers on forced
    host devices.
  * :class:`AbstractMesh` holds names and sizes only, for the rule tables
    (``launch/sharding.py``) and their tests.

Nothing here touches a device or a process group at import.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.common.device import DeviceLike, resolve_device

# --- NVIDIA H100 80GB HBM3 (SXM5) per-card constants, from NVIDIA's H100
# spec sheet (dense rates, no sparsity, at the 700 W power limit) ---------
PEAK_FLOPS_FP32 = 67e12          # FLOP/s, CUDA cores
PEAK_FLOPS_BF16 = 989e12         # FLOP/s, dense tensor cores
HBM_BW = 3.35e12                 # bytes/s
NVLINK_BW = 4.5e11               # bytes/s per direction (NVLink 4, 18 links; 450 GB/s)

DEBUG_AXES = ("data", "model")
PRODUCTION_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


class AbstractMesh:
    """Mesh dim names and sizes without devices or a process group; it
    answers the ``mesh_dim_names``, ``shape`` and ``size()`` that the rule
    tables read from a :class:`DeviceMesh`."""

    def __init__(self, sizes: Tuple[int, ...], names: Tuple[str, ...]):
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} names")
        self.shape = tuple(int(s) for s in sizes)
        self.mesh_dim_names = tuple(names)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if mesh_dim is None else self.shape[mesh_dim]

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def _init_world(backend: str, world_size: int) -> None:
    """Start a process group of ``world_size`` as rank 0 over an in-memory
    store, unless one exists; an existing one must have that size."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of world size {dist.get_world_size()} is live; "
                f"this mesh needs {world_size}")
        return
    store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=world_size)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, *,
                    device: Optional[DeviceLike] = None) -> DeviceMesh:
    """An ``n_data`` x ``n_model`` mesh named ``("data", "model")`` on the
    CUDA card (``device="cpu"`` for the CPU; with no card and no device it
    raises, as every entry point does). With no process group, a world of
    one is started: NCCL on CUDA, gloo on the CPU. A larger mesh needs the
    caller's process group of ``n_data * n_model`` ranks."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a debug mesh runs on cuda or cpu, not {dev.type}")
    n = n_data * n_model
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {n_data}x{n_model} mesh needs a process group of {n} ranks; "
                "start one with torch.distributed.init_process_group first")
        _init_world("nccl" if dev.type == "cuda" else "gloo", 1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (n_data, n_model), mesh_dim_names=DEBUG_AXES)


def make_fake_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]) -> DeviceMesh:
    """A CPU mesh of ``shape`` as rank 0 of a fake process group of that
    many ranks, started unless one is live. Tensors on it are meant to be
    fake (the dry-run): the fake group's collectives move no data."""
    # The fake backend is registered by importing this module of torch's
    # test utilities (in torch 2.11 and 2.13 alike); it is imported here
    # only, at the one place that needs the backend.
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    _init_world("fake", math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The 16x16 mesh ``("data", "model")``, or 2x16x16 ``("pod", "data",
    "model")``, over a fake process group of 256 or 512 ranks
    (:func:`make_fake_mesh`)."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), MULTI_POD_AXES)
    return make_fake_mesh((16, 16), PRODUCTION_AXES)


def mesh_chips(mesh) -> int:
    """Devices in ``mesh``."""
    return mesh.size()
