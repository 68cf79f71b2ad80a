"""Message transports for the distributed serving plane.

The port of ``repro.distributed.transport``, without
``SocketTransport``: the in-process plane (this slice of the port) runs
on :class:`LocalTransport`, and length-prefixed TCP between OS processes
comes with the socket slice, which also brings ``host.py`` and
``shard.py``.

The plane's components (:class:`~repro_torch.distributed.plane.ServingPlane`,
:class:`~repro_torch.distributed.coordinator.Coordinator`) talk only in
:class:`~repro_torch.distributed.messages.Message` values through this
interface:

  * ``bind(wid, handler)`` — register ``handler(msg) -> payload | None``
    as endpoint ``wid``;
  * ``send(msg)`` — one-way, no reply;
  * ``request(msg, timeout)`` — deliver and return the reply ``Message``.

Implementations:

  * :class:`LocalTransport` — deterministic in-process loopback. Delivery
    is a synchronous handler call and the ``Message`` (payload included)
    is passed **by reference**: no serialization, object identity
    preserved, seeded replays byte-identical. Routers cross by reference
    too, so N workers on one card share one pool and one router's tensors.
  * :class:`FaultyTransport` — a seeded fault-injection wrapper (drop /
    duplicate / reorder applied to one-way ``send`` traffic) for testing
    the protocol's loss tolerance; ``request`` stays reliable, mirroring
    a retried RPC.

Failure surface: every delivery problem raises :class:`TransportError`.
Callers treat an unreachable endpoint as a (possibly transient)
partition — the coordinator skips it for the round, the plane lets the
crash/rejoin machinery reconcile.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Dict, Optional

from repro_torch.distributed import messages as M
from repro_torch.distributed.messages import Message


class TransportError(RuntimeError):
    """Endpoint unreachable / timed out / connection lost."""


Handler = Callable[[Message], Optional[dict]]


class RpcStats:
    """RPC accounting for one transport endpoint.

    Request counters and byte totals are deterministic for a seeded
    ``LocalTransport`` run (the message sequence IS the replay contract);
    the per-kind latency histograms are wall-measured and must be
    registered as wall metrics, excluded from deterministic snapshots
    (see :func:`repro_torch.obs.wiring.register_transport_metrics`).
    """

    def __init__(self):
        self.requests: Dict[str, int] = {}       # kind -> completed RPCs
        self.peer_requests: Dict[int, int] = {}  # peer wid -> completed RPCs
        self.bytes_out: Dict[int, int] = {}      # peer wid -> frame bytes
        self.bytes_in: Dict[int, int] = {}
        self.latency: Dict[str, object] = {}     # kind -> wall-s Histogram
        self.retries = 0        # connect() re-dials
        self.timeouts = 0
        self.unreachable = 0
        self.errors = 0         # remote handler failures (ERROR replies)
        self.in_flight = 0

    def note_request(self, peer: int, kind: str, wall_s: float) -> None:
        self.requests[kind] = self.requests.get(kind, 0) + 1
        peer = int(peer)
        self.peer_requests[peer] = self.peer_requests.get(peer, 0) + 1
        h = self.latency.get(kind)
        if h is None:
            from repro_torch.serving.telemetry import Histogram

            h = self.latency[kind] = Histogram()
        h.record(wall_s)

    def note_io(self, peer: int, *, out: int = 0, inb: int = 0) -> None:
        peer = int(peer)
        if out:
            self.bytes_out[peer] = self.bytes_out.get(peer, 0) + out
        if inb:
            self.bytes_in[peer] = self.bytes_in.get(peer, 0) + inb

    def note_failure(self, exc: Exception) -> None:
        s = str(exc)
        if "timed out" in s:
            self.timeouts += 1
        elif "remote handler failed" in s:
            self.errors += 1
        else:
            self.unreachable += 1

    def merged_latency(self):
        """One histogram folding every kind's wall latency (for export)."""
        from repro_torch.serving.telemetry import Histogram

        out = Histogram()
        for h in self.latency.values():
            out.merge(h)
        return out


class Transport:
    # Fleet observability hooks — attached by the controller / follower host;
    # all default off, so a bare transport does zero extra work.
    tracer = None        # TraceRecorder: client ``rpc`` spans when set
    trace_wid = 0        # pid the client spans render under
    now = 0.0            # virtual clock, stamped by the driving loop
    now_fn = None        # live virtual-clock read (follower worker clock)
    stats: Optional[RpcStats] = None

    def _tnow(self) -> float:
        fn = self.now_fn
        return self.now if fn is None else float(fn())

    def _trace_client(self, msg: Message, t0: float) -> None:
        """Client-side ``rpc`` span, emitted after a successful reply (so
        a client span's existence implies the server handled the call —
        the span-tree validator relies on that pairing)."""
        tr = self.tracer
        if tr is not None and msg.kind in M.RPC_SPAN_KINDS:
            tr.span("rpc", "rpc", t0, self._tnow(), wid=self.trace_wid,
                    args={"rpc": msg.seq, "kind": msg.kind,
                          "side": "client", "peer": int(msg.dst)})

    def bind(self, wid: int, handler: Handler) -> None:
        raise NotImplementedError

    def send(self, msg: Message) -> None:
        raise NotImplementedError

    def request(self, msg: Message, timeout: Optional[float] = None
                ) -> Message:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _dispatch(handler: Handler, msg: Message) -> Message:
    """Run a handler and wrap its return payload as the reply message."""
    try:
        payload = handler(msg)
    except TransportError:
        raise
    except Exception as exc:  # surfaced to the requester, not swallowed
        return Message(kind=M.ERROR, dst=msg.src, src=msg.dst,
                       reply_to=msg.seq,
                       payload={"error": f"{type(exc).__name__}: {exc}"})
    return Message(kind=M.ACK, dst=msg.src, src=msg.dst, reply_to=msg.seq,
                   payload=payload if payload is not None else {})


def _check_reply(rep: Message) -> Message:
    if rep.kind == M.ERROR:
        raise TransportError(
            f"remote handler failed: {rep.payload.get('error')}")
    return rep


class LocalTransport(Transport):
    """In-process loopback bus: synchronous, by-reference, deterministic.

    Delivery order is the caller's call order — exactly the shared-object
    call sequence the plane executed before the message-passing refactor,
    which is what keeps seeded runs bit-identical across the change.
    """

    def __init__(self):
        self._handlers: Dict[int, Handler] = {}
        self._seq = 0
        self.stats = RpcStats()

    def bind(self, wid: int, handler: Handler) -> None:
        self._handlers[int(wid)] = handler

    def _deliver(self, msg: Message) -> Message:
        handler = self._handlers.get(msg.dst)
        if handler is None:
            raise TransportError(f"no endpoint bound for wid {msg.dst}")
        # Handler exceptions propagate raw: in-process, a crash is a crash
        # (tests want the traceback, not an ERROR frame).
        payload = handler(msg)
        return Message(kind=M.ACK, dst=msg.src, src=msg.dst,
                       reply_to=msg.seq,
                       payload=payload if payload is not None else {})

    def send(self, msg: Message) -> None:
        self._deliver(msg)

    def request(self, msg: Message, timeout: Optional[float] = None
                ) -> Message:
        self._seq += 1
        msg.seq = self._seq
        msg.expect_reply = True
        t0 = self._tnow()
        wall0 = time.perf_counter()
        s = self.stats
        try:
            rep = _check_reply(self._deliver(msg))
        except TransportError as exc:
            if s is not None:
                s.note_failure(exc)
            raise
        if s is not None:
            s.note_request(msg.dst, msg.kind, time.perf_counter() - wall0)
        self._trace_client(msg, t0)
        return rep


class FaultyTransport(Transport):
    """Seeded drop/duplicate/reorder wrapper over another transport.

    Faults apply to one-way ``send`` traffic only (broadcast-shaped
    messages, where the protocol must tolerate loss); ``request`` passes
    through reliably. Reordering holds a message back and flushes held
    messages *after* later sends — a bounded, seeded shuffle.
    """

    def __init__(self, inner: Transport, *, seed: int = 0,
                 drop: float = 0.0, dup: float = 0.0, reorder: float = 0.0):
        self.inner = inner
        self.rng = random.Random(seed)
        self.drop, self.dup, self.reorder = drop, dup, reorder
        self._held: list = []
        self.stats = {"sent": 0, "dropped": 0, "duplicated": 0, "held": 0}

    def bind(self, wid: int, handler: Handler) -> None:
        self.inner.bind(wid, handler)

    def send(self, msg: Message) -> None:
        self.stats["sent"] += 1
        if self.rng.random() < self.drop:
            self.stats["dropped"] += 1
            return
        copies = [msg]
        if self.rng.random() < self.dup:
            self.stats["duplicated"] += 1
            copies.append(msg)
        if self.rng.random() < self.reorder:
            self.stats["held"] += 1
            self._held.extend(copies)
            return
        for m in copies:
            self.inner.send(m)
        self.flush()

    def flush(self) -> None:
        """Deliver held (reordered) messages in seeded shuffled order."""
        held, self._held = self._held, []
        self.rng.shuffle(held)
        for m in held:
            self.inner.send(m)

    def request(self, msg: Message, timeout: Optional[float] = None
                ) -> Message:
        return self.inner.request(msg, timeout)

    def close(self) -> None:
        self.flush()
        self.inner.close()
