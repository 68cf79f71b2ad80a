"""Pool-member sharding: each worker owns a shard of the LM pool.

The port of ``repro.distributed.shard``. The paper's setting (and
RouterBench's) is a pool of heterogeneous LLMs too large to co-host: the
router is tiny, the members are not. This module splits pool ownership
across the worker fleet:

  * :func:`owner_of` — deterministic member -> worker placement
    (round-robin by index, stable under worker count);
  * :func:`shard_pool` — on a worker process, lay out the *owned*
    members' parameters and evict the parameters of members this worker
    does not own (scoring never reads them; only ``PoolMember.generate``
    does). With a ``mesh`` the layout is the reference's: each owned
    member's params become DTensors placed by the repo's per-config
    sharding specs (:func:`repro_torch.launch.sharding.param_shardings`,
    the tables production meshes use) and generation runs on them.
    Without one, each owned member stays whole on the worker's device:
    the layout the reference's default 1x1 debug mesh gives, without
    DTensor's per-op host dispatch;
  * :class:`PoolDispatcher` — the scheduler-side indirection: a generate
    micro-batch for a member this worker owns runs locally, any other
    member's batch becomes a ``GENERATE`` message to the owning worker.

A process that builds only its owned members in the first place
(``launch/serve.py::build_pool`` with ``owned``) never holds the others'
params; :func:`shard_pool` then only confirms the layout.

The dispatcher preserves ``RoutedEngine.generate_member``'s exact
signature and return contract (per-request output token rows + $ costs),
so the scheduler's delivered-work pricing and telemetry are oblivious to
where the member actually ran.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import flatten_with_paths, tree_map
from repro_torch.distributed import messages as M
from repro_torch.distributed.messages import Message
from repro_torch.launch.sharding import distribute_params
from repro_torch.launch.steps import check_mesh, make_generate


def owner_of(member_idx: int, n_workers: int) -> int:
    """Which worker owns pool member ``member_idx`` (round-robin)."""
    if n_workers <= 0:
        raise ValueError("n_workers must be positive")
    return int(member_idx) % int(n_workers)


def owned_members(wid: int, n_members: int, n_workers: int) -> List[int]:
    return [mi for mi in range(n_members)
            if owner_of(mi, n_workers) == int(wid)]


def shard_pool(pool, wid: int, n_workers: int, *, mesh=None, device=None,
               evict: bool = True) -> List[int]:
    """Lay out this worker's owned members; evict the rest.

    Returns the owned member indices. An owned member must hold its params
    (a process that built it evicted cannot serve it). With ``evict=True``
    the non-owned members' params and stub media are dropped (the memory
    win that makes this sharding real); their generates must go through a
    :class:`PoolDispatcher`.

    With ``mesh`` (a ``DeviceMesh`` with ``data`` and ``model`` dims,
    ``launch/mesh.py``; anything else raises as the mesh steps do) each
    owned member's params become DTensors under the reference's
    ``param_shardings``, one member and one leaf at a time, so no second
    copy of the pool is ever alive; its stub media is replicated over the
    mesh, and the member records the mesh and the greedy loop on its steps
    (``launch/steps.py::make_generate``), which ``PoolMember.generate``
    runs. Generation on a mesh is SPMD:
    on a mesh of several ranks, every rank must make the same generate
    calls, with the same prompts, in the same order, as the collectives
    of one call pair up across ranks. Routing is seeded, so ranks that
    serve the same texts from the same seed make the same calls; nothing
    here broadcasts or coordinates them, as in the reference.

    With ``mesh=None`` each owned member is placed whole on ``device``
    (resolved as every entry point's: the CUDA card unless named).
    """
    check_mesh(mesh)
    if mesh is None:
        device = resolve_device(device)
    owned = []
    for mi, member in enumerate(pool):
        if owner_of(mi, n_workers) == int(wid):
            if member.params is None:
                raise ValueError(f"worker {wid} owns pool member {mi} "
                                 f"({member.name}) but holds no params for it")
            if mesh is not None:
                distribute_params(member.cfg, mesh, member.params)
                if member.media is not None:
                    member.media = distribute_tensor(member.media, mesh,
                                                     [Replicate()] * mesh.ndim)
            else:
                member.params = tree_map(
                    lambda t: t.to(device) if isinstance(t, torch.Tensor) else t,
                    member.params)
                if member.media is not None:
                    member.media = member.media.to(device)
            member.mesh, member.greedy = mesh, make_generate(member.cfg, mesh)
            owned.append(mi)
        elif evict:
            member.params = None
            member.media = None
            member.mesh, member.greedy = None, None
    return owned


class PoolDispatcher:
    """Routes generate micro-batches to the member's owning worker.

    Installed as the scheduler's ``dispatcher``: the scheduler calls
    :meth:`generate_member` exactly where it would call the engine's, and
    the dispatcher either runs the batch on the local engine (owned
    member) or ships it as one ``GENERATE`` request to the owner over the
    transport. Remote costs come back as the owner priced them — the
    member's per-token rate is placement-independent, so the budget
    ledger sees identical $ either way.
    """

    def __init__(self, wid: int, n_workers: int, engine, transport):
        self.wid = int(wid)
        self.n_workers = int(n_workers)
        self.engine = engine
        self.transport = transport
        self.stats = {"local": 0, "remote": 0}
        # Trace context for the NEXT generate (set by the scheduler per
        # micro-batch): stamped onto the GENERATE frame so the owner's
        # server span joins the requesting request's causal chain.
        self.trace_key = None
        self.parent_span = None
        # After each call: the remote GENERATE's rpc link id (the request
        # seq, echoed as the reply's reply_to) — None for a local run. The
        # scheduler attaches it to the leg/generate spans as the `rpc` arg.
        self.last_rpc = None

    def owns(self, member_idx: int) -> bool:
        return owner_of(member_idx, self.n_workers) == self.wid

    def generate_member(self, member_idx: int, prompts,
                        max_new: int = 8,
                        max_new_per_req: Optional[List[int]] = None):
        if self.owns(member_idx):
            self.stats["local"] += 1
            self.last_rpc = None
            return self.engine.generate_member(
                member_idx, prompts, max_new=max_new,
                max_new_per_req=max_new_per_req)
        self.stats["remote"] += 1
        owner = owner_of(member_idx, self.n_workers)
        rep = self.transport.request(Message(
            kind=M.GENERATE, dst=owner,
            trace_key=self.trace_key, parent_span=self.parent_span,
            payload={"member": int(member_idx),
                     "prompts": [np.asarray(p) for p in prompts],
                     "max_new": int(max_new),
                     "max_new_per_req": (None if max_new_per_req is None
                                         else [int(m)
                                               for m in max_new_per_req])}))
        self.last_rpc = rep.reply_to
        outs = [np.asarray(o) for o in rep.payload["outs"]]
        costs = np.asarray(rep.payload["costs"], np.float64)
        return outs, costs


def pool_param_bytes(pool) -> int:
    """Bytes of the params and stub media this process holds for ``pool``
    (0 for an evicted member; a DTensor counts its local shard)."""
    local = [t.to_local() if isinstance(t, DTensor) else t
             for member in pool for part in (member.params, member.media)
             if part is not None
             for t in flatten_with_paths(part).values()
             if isinstance(t, torch.Tensor)]
    return sum(int(t.numel()) * t.element_size() for t in local)
