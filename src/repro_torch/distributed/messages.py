"""Typed, versioned message codec for the distributed serving plane.

The port of ``repro.distributed.messages``, whole: the same kinds, the
same ``Message`` and the same tagged codec, so both packages frame the same
payload into the same bytes and each decodes the other's frames. A router
crosses as numpy on the host: its tensors are copied off their device with
their dtypes, and :func:`router_from_state` (or :func:`decode`) puts them
back on a device resolved as every entry point resolves one (the CUDA card
unless the caller names another). A tensor anywhere else in a payload is
encoded as the numpy array it converts to; one left on the card refuses to
convert and raises ``TypeError``.

Every protocol interaction between the plane's components — replay-merge
gathers, router broadcasts with version fencing, ledger spend reports,
drift-alarm cache invalidations, crash/rejoin, leader catch-up — is a
:class:`Message`: a ``kind`` from the closed vocabulary below, source and
destination worker ids, a sequence number (for request/reply pairing),
and a payload dict.

Two delivery regimes share the type:

  * :class:`~repro_torch.distributed.transport.LocalTransport` passes the
    ``Message`` object **by reference** — payload objects (``Request``
    instances, routers, replay batches) keep their identity, which the
    in-process plane relies on (served-request mutations must land on
    the trace's original objects) and which makes seeded replays
    byte-identical by construction.
  * :class:`~repro_torch.distributed.transport.SocketTransport` frames
    ``encode(msg)`` bytes over TCP. The codec is a small self-contained
    tagged binary format (no pickle): scalars, strings, bytes,
    containers, and ndarrays (dtype + shape + raw C-order buffer —
    lossless, including float NaN/inf), plus adapters for the domain
    objects that cross process boundaries (``PredictiveRouter``,
    ``Request``, ``Telemetry`` and its ``Histogram``/``BoundedSeries``
    internals).

The frame starts with ``MAGIC`` + ``PROTOCOL_VERSION``; a receiver on a
different protocol version rejects the frame outright instead of
misparsing it.

Version 2 added the optional trace context ``(trace_key, parent_span)``
to every frame (fleet-wide RPC tracing) and the ``METRICS_REQ`` kind
(federated metrics scrape). Both ride the same field dict the codec has
always encoded, so a v2 decoder accepts frames with or without them;
v1 decoders reject v2 frames at the version byte.
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

MAGIC = b"RMSG"
PROTOCOL_VERSION = 2

# -- message kinds -----------------------------------------------------------
# Session / control
HELLO = "hello"                  # follower -> controller: wid, pid
ACK = "ack"                      # generic reply envelope
ERROR = "error"                  # handler raised: payload {"error": str}
SHUTDOWN = "shutdown"            # controller -> follower: exit serve loop
# Coordinator sync protocol
SYNC_STATUS = "sync_status"      # -> {alive, version, has_adapter,
#                                      pending_burst, added, distinct}
REPLAY_SAMPLE = "replay_sample"  # {n, recent_frac} -> {batch}
ROUTER_BCAST = "router_bcast"    # {router} -> {accepted, version}
CLEAR_BURST = "clear_burst"      # leader ran the concentrated burst
CACHE_INVAL = "cache_inval"      # {mode, now}: fleet-wide semcache inval
# Plane event loop
ASSIGN = "assign"                # {reqs}: merge into worker arrivals
NEXT_ACTION = "next_action"      # -> {t}
STEP = "step"                    # {t} -> {n_served, now}
CRASH = "crash"                  # {t} -> {orphans}
REJOIN = "rejoin"                # {t, router, replay_seed}
TICK = "tick"                    # {t}: final staged-feedback flush
FINALIZE = "finalize"            # {t, check_slo}: end-of-run bookkeeping
# Sharded-pool dispatch and shared services
GENERATE = "generate"            # {member, prompts, max_new,
#                                   max_new_per_req} -> {outs, costs}
LEDGER_OP = "ledger_op"          # {op, args} -> {result, lam, ...}
TELEMETRY_REQ = "telemetry_req"  # -> {telemetry, served, queue}
TRACE_REQ = "trace_req"          # -> {events, next_key} recorder drain
METRICS_REQ = "metrics_req"      # -> {prom}: follower registry scrape

KINDS = frozenset(v for k, v in list(globals().items())
                  if k.isupper() and isinstance(v, str))

# Kinds that emit client/server ``rpc`` trace spans. Deliberately
# excluded: NEXT_ACTION (per-iteration polling noise), connection control
# (HELLO/ACK/ERROR/SHUTDOWN), one-way broadcasts (CLEAR_BURST /
# CACHE_INVAL — loss-tolerant, a client span would imply a handled
# request), and the obs drain traffic itself (TELEMETRY_REQ / TRACE_REQ /
# METRICS_REQ — wall-driven, must not perturb deterministic traces).
RPC_SPAN_KINDS = frozenset({
    SYNC_STATUS, REPLAY_SAMPLE, ROUTER_BCAST, ASSIGN, STEP, CRASH,
    REJOIN, TICK, FINALIZE, GENERATE, LEDGER_OP,
})


@dataclasses.dataclass
class Message:
    kind: str
    dst: int
    src: int = -1
    seq: int = -1
    reply_to: Optional[int] = None
    expect_reply: bool = False
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Trace context (protocol v2): the request-tree key and parent span
    # link id this frame does work for, so the receiving worker's spans
    # join the sender's causal chain across process boundaries.
    trace_key: Optional[int] = None
    parent_span: Optional[int] = None


# -- domain-object adapters --------------------------------------------------

def _tree_to_np(tree):
    """Materialize a params tree (dicts/lists/tuples of tensors) to numpy
    on the host, keeping each leaf's dtype."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _tree_to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_np(v) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return np.asarray(tree)


def router_to_state(router) -> Dict[str, Any]:
    return {
        "quality_kind": router.quality_kind,
        "cost_kind": router.cost_kind,
        "quality_params": _tree_to_np(router.quality_params),
        "cost_params": _tree_to_np(router.cost_params),
        "model_emb": np.asarray(router.model_emb),
        "reward": router.reward,
        "cost_scaler": _tree_to_np(router.cost_scaler),
        "version": int(router.version),
        "centroids": (None if router.centroids is None
                      else np.asarray(router.centroids)),
    }


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_torch(v, device) for v in tree)
    # np.array, not np.ascontiguousarray, which makes a 0-d leaf 1-d.
    return torch.from_numpy(np.array(tree)).to(device)


def router_from_state(state: Dict[str, Any], device=None):
    """A router from :func:`router_to_state`'s dict: predictor params as
    tensors on ``device`` (resolved: the CUDA card unless named), the
    model embeddings, cost scaler and centroids numpy, as a router holds
    them."""
    from repro_torch.common.device import resolve_device
    from repro_torch.core.router import PredictiveRouter

    device = resolve_device(device)
    state = dict(state)
    for key in ("quality_params", "cost_params"):
        state[key] = _tree_to_torch(state[key], device)
    return PredictiveRouter(**state)


def request_to_state(req) -> Dict[str, Any]:
    return {f.name: getattr(req, f.name) for f in dataclasses.fields(req)}


def request_from_state(state: Dict[str, Any]):
    from repro_torch.serving.queue import Request
    return Request(**state)


def telemetry_to_state(tel) -> Dict[str, Any]:
    return dict(vars(tel))


def telemetry_from_state(state: Dict[str, Any]):
    from repro_torch.serving.telemetry import Telemetry
    tel = Telemetry(state["member_names"])
    for k, v in state.items():
        setattr(tel, k, v)
    return tel


def _histogram_to_state(h) -> Dict[str, Any]:
    return {"edges": h.edges, "counts": h.counts, "count": h.count,
            "total": h.total, "min": h.min, "max": h.max,
            "exemplars": {k: tuple(v) for k, v in h.exemplars.items()}}


def _histogram_from_state(state: Dict[str, Any]):
    from repro_torch.serving.telemetry import Histogram
    h = Histogram()
    h.edges = np.asarray(state["edges"])
    h.counts = np.asarray(state["counts"])
    h.count = int(state["count"])
    h.total = float(state["total"])
    h.min = float(state["min"])
    h.max = float(state["max"])
    # Pre-exemplar peers omit the field; tolerate its absence.
    h.exemplars = {int(k): tuple(v)
                   for k, v in state.get("exemplars", {}).items()}
    return h


def _series_to_state(s) -> Dict[str, Any]:
    return {"cap": s.cap, "stride": s.stride, "n_seen": s.n_seen,
            "points": [list(p) for p in s._points]}


def _series_from_state(state: Dict[str, Any]):
    from repro_torch.serving.telemetry import BoundedSeries
    s = BoundedSeries(cap=int(state["cap"]))
    s.stride = int(state["stride"])
    s.n_seen = int(state["n_seen"])
    s._points = [tuple(p) for p in state["points"]]
    return s


# -- tagged binary codec -----------------------------------------------------
#
# One tag byte per value. Lengths/counts are u32 big-endian; ints i64;
# floats f64. Objects are encoded as (tag, state-dict) through the
# adapters above — the adapters, not the codec, own the field lists.

_T_NONE, _T_TRUE, _T_FALSE = b"N", b"T", b"F"
_T_INT, _T_BIGINT, _T_FLOAT = b"i", b"Z", b"f"
_T_STR, _T_BYTES = b"s", b"b"
_T_LIST, _T_TUPLE, _T_SET, _T_DICT = b"l", b"t", b"e", b"d"
_T_NDARRAY = b"a"
_T_ROUTER, _T_REQUEST, _T_TELEMETRY = b"R", b"Q", b"Y"
_T_HISTOGRAM, _T_SERIES = b"H", b"G"


def _enc(obj, out: list) -> None:
    if obj is None:
        out.append(_T_NONE)
    elif obj is True:
        out.append(_T_TRUE)
    elif obj is False:
        out.append(_T_FALSE)
    elif isinstance(obj, np.bool_):
        out.append(_T_TRUE if bool(obj) else _T_FALSE)
    elif isinstance(obj, (int, np.integer)):
        try:
            out.append(_T_INT + struct.pack(">q", int(obj)))
        except struct.error:
            raw = str(int(obj)).encode()
            out.append(_T_BIGINT + struct.pack(">I", len(raw)) + raw)
    elif isinstance(obj, (float, np.floating)):
        out.append(_T_FLOAT + struct.pack(">d", float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_T_STR + struct.pack(">I", len(raw)) + raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_T_BYTES + struct.pack(">I", len(obj)) + bytes(obj))
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise TypeError(
                "unencodable message value: object-dtype ndarray")
        arr = np.ascontiguousarray(obj)
        dt = arr.dtype.str.encode()
        raw = arr.tobytes()
        out.append(_T_NDARRAY + struct.pack(">B", len(dt)) + dt
                   + struct.pack(">B", arr.ndim)
                   + b"".join(struct.pack(">I", d) for d in arr.shape)
                   + struct.pack(">I", len(raw)) + raw)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        tag = (_T_LIST if isinstance(obj, list)
               else _T_TUPLE if isinstance(obj, tuple) else _T_SET)
        items = sorted(obj, key=repr) if tag == _T_SET else obj
        out.append(tag + struct.pack(">I", len(obj)))
        for v in items:
            _enc(v, out)
    elif isinstance(obj, dict):
        out.append(_T_DICT + struct.pack(">I", len(obj)))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    else:
        name = type(obj).__name__
        adapters = {
            "PredictiveRouter": (_T_ROUTER, router_to_state),
            "Request": (_T_REQUEST, request_to_state),
            "Telemetry": (_T_TELEMETRY, telemetry_to_state),
            "Histogram": (_T_HISTOGRAM, _histogram_to_state),
            "BoundedSeries": (_T_SERIES, _series_to_state),
        }
        if name in adapters:
            tag, to_state = adapters[name]
            out.append(tag)
            _enc(to_state(obj), out)
            return
        # Host tensors (or anything array-like) degrade to a numpy snapshot.
        try:
            arr = np.asarray(obj)
        except Exception:
            raise TypeError(
                f"unencodable message value of type {type(obj)!r}")
        if arr.dtype == object:
            raise TypeError(
                f"unencodable message value of type {type(obj)!r}")
        _enc(arr, out)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated message frame")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]


def _dec(r: _Reader, device=None):
    tag = r.take(1)
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return struct.unpack(">q", r.take(8))[0]
    if tag == _T_BIGINT:
        return int(r.take(r.u32()).decode())
    if tag == _T_FLOAT:
        return struct.unpack(">d", r.take(8))[0]
    if tag == _T_STR:
        return r.take(r.u32()).decode("utf-8")
    if tag == _T_BYTES:
        return r.take(r.u32())
    if tag == _T_NDARRAY:
        dt = np.dtype(r.take(struct.unpack(">B", r.take(1))[0]).decode())
        ndim = struct.unpack(">B", r.take(1))[0]
        shape = tuple(r.u32() for _ in range(ndim))
        raw = r.take(r.u32())
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if tag in (_T_LIST, _T_TUPLE, _T_SET):
        n = r.u32()
        items = [_dec(r, device) for _ in range(n)]
        if tag == _T_TUPLE:
            return tuple(items)
        if tag == _T_SET:
            return set(items)
        return items
    if tag == _T_DICT:
        n = r.u32()
        return {_dec(r, device): _dec(r, device) for _ in range(n)}
    if tag == _T_ROUTER:
        return router_from_state(_dec(r, device), device)
    if tag == _T_REQUEST:
        return request_from_state(_dec(r, device))
    if tag == _T_TELEMETRY:
        return telemetry_from_state(_dec(r, device))
    if tag == _T_HISTOGRAM:
        return _histogram_from_state(_dec(r, device))
    if tag == _T_SERIES:
        return _series_from_state(_dec(r, device))
    raise ValueError(f"unknown codec tag {tag!r}")


def encode(msg: Message) -> bytes:
    """Message -> length-independent frame body (transport adds framing)."""
    out = [MAGIC, struct.pack(">B", PROTOCOL_VERSION)]
    _enc({
        "kind": msg.kind, "dst": msg.dst, "src": msg.src, "seq": msg.seq,
        "reply_to": msg.reply_to, "expect_reply": msg.expect_reply,
        "payload": msg.payload, "trace_key": msg.trace_key,
        "parent_span": msg.parent_span,
    }, out)
    return b"".join(out)


def router_digest(router) -> str:
    """A short sha256 of the router's codec state (predictor params, model
    embeddings, cost scaler, centroids, kinds, reward and version): two
    routers have the same digest when they are bitwise equal, whatever
    device or process holds them."""
    out: list = []
    _enc(router_to_state(router), out)
    return hashlib.sha256(b"".join(out)).hexdigest()[:16]


def decode(buf: bytes, device=None) -> Message:
    """Frame body -> Message; a router in it lands on ``device`` (resolved:
    the CUDA card unless named)."""
    if buf[:4] != MAGIC:
        raise ValueError("bad message magic")
    ver = struct.unpack(">B", buf[4:5])[0]
    if ver != PROTOCOL_VERSION:
        raise ValueError(f"protocol version mismatch: "
                         f"got {ver}, want {PROTOCOL_VERSION}")
    fields = _dec(_Reader(buf[5:]), device)
    return Message(kind=fields["kind"], dst=fields["dst"], src=fields["src"],
                   seq=fields["seq"], reply_to=fields["reply_to"],
                   expect_reply=fields["expect_reply"],
                   payload=fields["payload"],
                   trace_key=fields.get("trace_key"),
                   parent_span=fields.get("parent_span"))
