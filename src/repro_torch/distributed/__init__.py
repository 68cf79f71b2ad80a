"""Multi-worker serving plane: the serve->learn loop across N workers.

Converts every in-process singleton of the single-worker online loop into
an explicitly synchronized, worker-replicated component, communicating
through typed messages over a pluggable transport:

  * :mod:`messages` — the typed, versioned message vocabulary and the
    lossless binary codec for the socket wire;
  * :mod:`transport` — :class:`Transport` with
    :class:`LocalTransport` (deterministic in-process loopback,
    by-reference delivery), :class:`SocketTransport` (length-prefixed
    TCP between real OS processes), and :class:`FaultyTransport`
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
    events, and per-worker telemetry rollup;
  * :mod:`shard` — pool-member ownership across workers and the
    scheduler-side dispatcher that routes generate legs to the owner;
  * :mod:`host` — the follower process entry point
    (``python -m repro_torch.distributed.host``) and the controller-side
    :class:`RemoteWorkerProxy`.

The port of ``repro.distributed``, whole. Entry point:
``python -m repro_torch.launch.serve --workers N --transport
{local,socket}``. In process (``local``) every worker's engine shares one
pool; over ``socket`` each OS process builds and holds only the pool
members it owns.
"""
from repro_torch.distributed.coordinator import Coordinator, SyncConfig
from repro_torch.distributed.ledger import LedgerClient, SharedBudgetLedger
from repro_torch.distributed.messages import Message, decode, encode
from repro_torch.distributed.plane import PlaneEvent, ServingPlane
from repro_torch.distributed.shard import PoolDispatcher, owner_of
from repro_torch.distributed.transport import (
    FaultyTransport,
    LocalTransport,
    SocketTransport,
    Transport,
    TransportError,
)
from repro_torch.distributed.worker import WorkerNode

__all__ = [
    "Coordinator", "FaultyTransport", "LedgerClient", "LocalTransport",
    "Message", "PlaneEvent", "PoolDispatcher", "ServingPlane",
    "SharedBudgetLedger", "SocketTransport", "SyncConfig", "Transport",
    "TransportError", "WorkerNode", "decode", "encode", "owner_of",
]
