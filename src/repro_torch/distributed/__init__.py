"""Multi-worker serving plane: the serve->learn loop across N workers.

Converts every in-process singleton of the single-worker online loop into
an explicitly synchronized, worker-replicated component, communicating
through typed messages over a pluggable transport:

  * :mod:`messages` — the typed, versioned message vocabulary and the
    lossless binary codec for the socket wire;
  * :mod:`transport` — :class:`Transport` with
    :class:`LocalTransport` (deterministic in-process loopback,
    by-reference delivery) and :class:`FaultyTransport`
    (seeded drop/dup/reorder fault injection for tests);
  * :mod:`worker` — :class:`WorkerNode`: engine replica + scheduler +
    local replay, a transport endpoint with crash/rejoin semantics;
  * :mod:`coordinator` — :class:`Coordinator`: seeded deterministic replay
    merge onto the leader, bounded leader updates, versioned router
    broadcast with stale-publish rejection, lowest-id leader election;
  * :mod:`ledger` — :class:`SharedBudgetLedger`: one global $/window
    budget across all workers' governors; :class:`LedgerClient`: the
    remote-process facade for it;
  * :mod:`plane` — :class:`ServingPlane`: the deterministic multi-clock
    event loop, round-robin request assignment, scenario (crash/rejoin)
    events, and per-worker telemetry rollup.

The port of ``repro.distributed``'s in-process part. ``shard.py``
(pool ownership across processes), ``host.py`` (the follower process) and
``SocketTransport`` wait for the socket slice of the port; until then
``repro_torch.launch.serve --workers N`` runs the plane over
:class:`LocalTransport`, with every worker's engine sharing one pool.
"""
from repro_torch.distributed.coordinator import Coordinator, SyncConfig
from repro_torch.distributed.ledger import LedgerClient, SharedBudgetLedger
from repro_torch.distributed.messages import Message, decode, encode
from repro_torch.distributed.plane import PlaneEvent, ServingPlane
from repro_torch.distributed.transport import (
    FaultyTransport,
    LocalTransport,
    Transport,
    TransportError,
)
from repro_torch.distributed.worker import WorkerNode

__all__ = [
    "Coordinator", "FaultyTransport", "LedgerClient", "LocalTransport",
    "Message", "PlaneEvent", "ServingPlane", "SharedBudgetLedger",
    "SyncConfig", "Transport", "TransportError", "WorkerNode", "decode",
    "encode",
]
