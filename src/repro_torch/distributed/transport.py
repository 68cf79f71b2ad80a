"""Message transports for the distributed serving plane.

The port of ``repro.distributed.transport``, whole. Its
:class:`SocketTransport` frames the reference's bytes, so either
package's controller can drive the other's followers; it decodes every
frame onto the device of the worker it carries (a router in a frame
lands there), where the reference's decoder names no device.

The plane's components (:class:`~repro_torch.distributed.plane.ServingPlane`,
:class:`~repro_torch.distributed.coordinator.Coordinator`, follower-side
proxies) talk only in
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
  * :class:`SocketTransport` — length-prefixed TCP between real OS
    processes (``u32`` big-endian frame length + codec bytes), with
    connect retry/backoff, per-message timeouts, and nested-RPC
    servicing: while a side waits for its reply it services interleaved
    inbound *requests* (a follower mid-``STEP`` can call back into the
    controller's ledger, or route a generate to a peer, without
    deadlock). Endpoints whose ``dst`` is not locally bound are routed
    through the controller, which forwards to the owning connection.
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
import socket
import struct
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


# -- socket transport --------------------------------------------------------

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 30


def _send_frame(conn: socket.socket, body: bytes) -> None:
    try:
        conn.sendall(_LEN.pack(len(body)) + body)
    except OSError as exc:
        raise TransportError(f"send failed: {exc}") from exc


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        try:
            part = conn.recv(min(n, 1 << 20))
        except socket.timeout as exc:
            raise TransportError("recv timed out") from exc
        except OSError as exc:
            raise TransportError(f"recv failed: {exc}") from exc
        if not part:
            raise TransportError("connection closed by peer")
        chunks.append(part)
        n -= len(part)
    return b"".join(chunks)


def _recv_frame(conn: socket.socket) -> bytes:
    n = _LEN.unpack(_recv_exact(conn, 4))[0]
    if n > MAX_FRAME:
        raise TransportError(f"oversized frame ({n} bytes)")
    return _recv_exact(conn, n)


class SocketTransport(Transport):
    """Length-prefixed TCP transport between real OS processes.

    One process is the **controller** (``wid 0``): it owns the listening
    socket and one accepted connection per follower. Followers each hold
    a single connection to the controller; messages between followers are
    routed through it (the controller forwards frames whose ``dst`` is
    neither itself nor the sender).

    The protocol is strictly synchronous lockstep (the plane's event loop
    drives every exchange), so each side is single-threaded: after
    writing a request it reads frames until one carries its
    ``reply_to``; any *request* frame that arrives meanwhile is a nested
    call from the peer (e.g. the follower asking the controller's ledger
    mid-``STEP``) and is serviced inline.

    ``device`` is where a router decoded from a frame is put: the device
    of the worker this endpoint carries (None resolves as every entry
    point does, to the CUDA card). Frames without a router never touch it.
    """

    CONNECT_RETRIES = 40
    CONNECT_BACKOFF_S = 0.25

    def __init__(self, wid: int, *, timeout: Optional[float] = 120.0,
                 device=None):
        self.wid = int(wid)
        self.timeout = timeout
        self.device = device
        self._handlers: Dict[int, Handler] = {}
        self._conns: Dict[int, socket.socket] = {}
        self._seq = self.wid * 1_000_000  # per-endpoint disjoint seq space
        self._listener: Optional[socket.socket] = None
        self.is_controller = self.wid == 0
        self.stats = RpcStats()

    # -- wiring --------------------------------------------------------------

    def bind(self, wid: int, handler: Handler) -> None:
        self._handlers[int(wid)] = handler

    def listen(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Controller: open the accept socket; returns the bound port."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(16)
        self._listener = srv
        return srv.getsockname()[1]

    def accept(self, n_followers: int, timeout: float = 60.0) -> Dict[int, dict]:
        """Controller: accept ``n_followers`` HELLOs; returns wid -> hello
        payload (pid etc.)."""
        assert self._listener is not None, "listen() first"
        self._listener.settimeout(timeout)
        hellos: Dict[int, dict] = {}
        while len(hellos) < n_followers:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout as exc:
                raise TransportError(
                    f"only {len(hellos)}/{n_followers} followers "
                    f"connected") from exc
            conn.settimeout(self.timeout)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello = M.decode(_recv_frame(conn), device=self.device)
            if hello.kind != M.HELLO:
                conn.close()
                continue
            wid = int(hello.payload["wid"])
            self._conns[wid] = conn
            hellos[wid] = dict(hello.payload)
            _send_frame(conn, M.encode(Message(
                kind=M.ACK, dst=wid, src=self.wid, reply_to=hello.seq)))
        return hellos

    def connect(self, port: int, host: str = "127.0.0.1", *,
                hello_payload: Optional[dict] = None) -> None:
        """Follower: dial the controller with retry/backoff, say HELLO."""
        last: Optional[Exception] = None
        for attempt in range(self.CONNECT_RETRIES):
            try:
                conn = socket.create_connection((host, port), timeout=10.0)
                break
            except OSError as exc:
                last = exc
                self.stats.retries += 1
                time.sleep(self.CONNECT_BACKOFF_S * min(attempt + 1, 8))
        else:
            raise TransportError(
                f"could not reach controller at {host}:{port}: {last}")
        conn.settimeout(self.timeout)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._conns[0] = conn
        payload = {"wid": self.wid}
        payload.update(hello_payload or {})
        _send_frame(conn, M.encode(Message(
            kind=M.HELLO, dst=0, src=self.wid, seq=self._next_seq(),
            payload=payload)))
        ack = M.decode(_recv_frame(conn), device=self.device)
        if ack.kind != M.ACK:
            raise TransportError(f"bad HELLO ack: {ack.kind}")

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _conn_for(self, dst: int) -> socket.socket:
        if dst in self._conns:
            return self._conns[dst]
        if not self.is_controller and 0 in self._conns:
            return self._conns[0]      # follower: everything via controller
        raise TransportError(f"no route to wid {dst}")

    def _peer_for(self, dst: int) -> int:
        """The wid on the other end of the conn frames to ``dst`` ride."""
        return int(dst) if dst in self._conns else 0

    # -- delivery ------------------------------------------------------------

    def _send_msg(self, conn: socket.socket, msg: Message,
                  peer: int) -> None:
        body = M.encode(msg)
        if self.stats is not None:
            self.stats.note_io(peer, out=len(body) + 4)
        _send_frame(conn, body)

    def _recv_msg(self, conn: socket.socket, peer: int) -> Message:
        buf = _recv_frame(conn)
        if self.stats is not None:
            self.stats.note_io(peer, inb=len(buf) + 4)
        return M.decode(buf, device=self.device)

    def _service(self, msg: Message) -> None:
        """Handle an inbound request/one-way frame (possibly forwarding)."""
        if msg.dst != self.wid and self.is_controller:
            # Route follower->follower traffic through our connections.
            try:
                if msg.expect_reply:
                    rep = self._roundtrip(self._conn_for(msg.dst), msg)
                else:
                    self._send_msg(self._conn_for(msg.dst), msg, msg.dst)
                    return
            except TransportError as exc:
                rep = Message(kind=M.ERROR, dst=msg.src, src=self.wid,
                              reply_to=msg.seq,
                              payload={"error": str(exc)})
            self._send_msg(self._conn_for(msg.src), rep, msg.src)
            return
        handler = self._handlers.get(msg.dst)
        if handler is None:
            rep = Message(kind=M.ERROR, dst=msg.src, src=self.wid,
                          reply_to=msg.seq,
                          payload={"error": f"no endpoint {msg.dst}"})
        else:
            rep = _dispatch(handler, msg)
        if msg.expect_reply:
            self._send_msg(self._conn_for(msg.src), rep,
                           self._peer_for(msg.src))

    def _roundtrip(self, conn: socket.socket, msg: Message) -> Message:
        peer = self._peer_for(msg.dst)
        self._send_msg(conn, msg, peer)
        while True:
            rep = self._recv_msg(conn, peer)
            if rep.reply_to == msg.seq:
                return rep
            # Nested inbound call while we wait: service it inline.
            self._service(rep)

    def send(self, msg: Message) -> None:
        msg.src = self.wid
        if msg.dst in self._handlers:   # local endpoint: loop back
            _dispatch(self._handlers[msg.dst], msg)
            return
        self._send_msg(self._conn_for(msg.dst), msg,
                       self._peer_for(msg.dst))

    def request(self, msg: Message, timeout: Optional[float] = None
                ) -> Message:
        msg.src = self.wid
        msg.seq = self._next_seq()
        msg.expect_reply = True
        t0 = self._tnow()
        wall0 = time.perf_counter()
        s = self.stats
        if msg.dst in self._handlers:   # local endpoint: loop back
            try:
                rep = _check_reply(_dispatch(self._handlers[msg.dst], msg))
            except TransportError as exc:
                if s is not None:
                    s.note_failure(exc)
                raise
            if s is not None:
                s.note_request(msg.dst, msg.kind,
                               time.perf_counter() - wall0)
            self._trace_client(msg, t0)
            return rep
        if s is not None:
            s.in_flight += 1
        try:
            conn = self._conn_for(msg.dst)
            if timeout is not None:
                conn.settimeout(timeout)
            try:
                rep = _check_reply(self._roundtrip(conn, msg))
            finally:
                if timeout is not None:
                    conn.settimeout(self.timeout)
        except TransportError as exc:
            if s is not None:
                s.note_failure(exc)
            raise
        finally:
            if s is not None:
                s.in_flight -= 1
        if s is not None:
            s.note_request(msg.dst, msg.kind, time.perf_counter() - wall0)
        self._trace_client(msg, t0)
        return rep

    # -- follower serve loop -------------------------------------------------

    def serve_forever(self) -> None:
        """Follower: service controller frames until SHUTDOWN / EOF.

        Raises :class:`TransportError` when the controller connection
        dies — the caller (``repro_torch.distributed.host``) degrades to
        follower-local serving instead of crashing.
        """
        conn = self._conns[0]
        conn.settimeout(None)           # idle between rounds is normal
        while True:
            msg = self._recv_msg(conn, 0)
            if msg.kind == M.SHUTDOWN:
                if msg.expect_reply:
                    _send_frame(conn, M.encode(Message(
                        kind=M.ACK, dst=msg.src, src=self.wid,
                        reply_to=msg.seq)))
                return
            self._service(msg)

    def drop_connection(self, wid: int) -> None:
        conn = self._conns.pop(wid, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        for wid in list(self._conns):
            self.drop_connection(wid)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
