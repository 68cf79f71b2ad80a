"""Structured per-request tracing over the serving runtime's virtual clocks.

The port's copy of ``repro.obs.trace``, pure Python: the same events, series
and bytes as the reference's for the same inputs.

One :class:`TraceRecorder` collects *events* — instants and completed spans
— from every subsystem a request flows through: admission, queue wait,
score batch, per-member generate micro-batches, each cascade leg, the
escalation decision (with the policy's expected-marginal-reward inputs),
budget-governor verdicts, online-adapter observe/update, and finalize.

Design constraints, in order:

  * **Deterministic.** Event timestamps come from the runtime's virtual
    clocks, request identity is a recorder-assigned dense *trace key*
    (admission order, never the process-global ``rid`` counter, which
    shifts between in-process replays), and the export serializes with
    sorted keys — so a seeded run's trace is bit-identical across
    replays. The only wall-clock events are kernel-profiling spans and the
    host tracer's spans (:mod:`repro_torch.obs.host_trace`), which live in
    the ``WALL_CATS`` categories and are excluded from the deterministic
    export.
  * **Cheap when off.** Every integration point is an ``if tracer is not
    None`` branch; with no recorder installed the runtime does zero extra
    work. When on, recording one event is a single tuple append.
  * **Fleet-aware.** Events carry a worker id; in the multi-worker plane
    all workers share one recorder through :meth:`TraceRecorder.scoped`
    views (the plane's event loop is single-process and deterministic),
    and independently-built recorders can still :meth:`merge` at rollup.

The export target is the Chrome trace-event JSON format (``ph: "X"``
complete spans + ``ph: "i"`` instants + ``ph: "C"`` counter samples, which
Perfetto renders as native counter tracks), loaded directly by Perfetto /
``chrome://tracing``: ``pid`` is the worker id, ``tid`` is the per-request
trace key (0 = scheduler/runtime scope). The reference's
``tools/trace_export.py`` reads the same documents.

**Streaming mode** (:mod:`repro_torch.obs.stream`) keeps the recorder bounded
for unbounded runs: events of *closed* request trees (root span recorded)
are periodically :meth:`~TraceRecorder.drain`-ed to rotating segment
files, optionally head+tail-sampled per request
(:mod:`repro_torch.obs.sampling`), and a hard per-worker buffered-event cap
sheds whole request trees (with drop accounting) under overload. With no
sampler/cap/drain the recorder behaves exactly as a plain append-only
log.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.sampling import is_anomaly_event

# Categories whose events carry wall-clock measurements; excluded from the
# deterministic export (and therefore from replay bit-identity checks).
WALL_CATS = frozenset({"kernel", "host"})

# Event tuple layout (kept a tuple, not a dict/dataclass: recording must be
# a single append on the scheduler hot path).
#   (name, cat, ph, ts_s, dur_s, wid, key, args)
_NAME, _CAT, _PH, _TS, _DUR, _WID, _KEY, _ARGS = range(8)


class TraceRecorder:
    """Append-only event log with deterministic per-request keys.

    ``sampler`` (a :class:`repro_torch.obs.sampling.TraceSampler`) and
    ``max_buffered_per_worker`` opt the recorder into streaming semantics:
    sampling is applied per closed request tree at :meth:`drain` time (so
    the tail-lane anomaly flag is known), and the cap sheds whole request
    trees at record time once a worker's buffered events exceed it. Both
    default off — a bare recorder keeps everything, exactly as before.
    """

    def __init__(self, label: str = "run", *, sampler=None,
                 max_buffered_per_worker: Optional[int] = None,
                 key_base: int = 0):
        self.label = label
        self.events: List[tuple] = []
        # ``key_base`` partitions the trace-key space across processes: a
        # socket-mode follower starts at ``wid * 1_000_000`` so its keys
        # never collide with the controller's when drained batches are
        # absorbed verbatim (no re-keying, links stay valid).
        self._next_key = int(key_base)
        self.sampler = sampler
        self.max_buffered_per_worker = max_buffered_per_worker
        # Streaming state: closed request trees awaiting drain, anomalous
        # keys (always-keep lane), shed keys (cap overflow), per-worker
        # buffered-event counts, and drop accounting.
        self._closed: set = set()
        self._anomaly: set = set()
        self._shed: set = set()
        self._buffered: Dict[int, int] = {}
        self.peak_buffered = 0
        self.stats = {"events": 0, "dropped_cap": 0, "dropped_sampled": 0,
                      "requests_closed": 0, "requests_sampled_out": 0,
                      "requests_shed": 0}

    # -- request identity ----------------------------------------------------

    def next_key(self) -> int:
        k = self._next_key
        self._next_key += 1
        return k

    def ensure_key(self, req) -> int:
        """Assign ``req.trace_key`` on first sight (admission order)."""
        if req.trace_key < 0:
            req.trace_key = self.next_key()
        return req.trace_key

    # -- recording -----------------------------------------------------------

    def _record(self, name: str, cat: str, ph: str, ts: float, dur: float,
                wid: int, key: Optional[int], args: Optional[dict]) -> None:
        """Single recording funnel: cap shedding, close/anomaly marking."""
        self.stats["events"] += 1
        if key is not None:
            if key in self._shed:
                self.stats["dropped_cap"] += 1
                return
            cap = self.max_buffered_per_worker
            if cap is not None and self._buffered.get(wid, 0) >= cap:
                # Hard cap: shed this request's tree (already-buffered
                # events of the key are discarded at the next drain).
                self._shed.add(key)
                self._closed.discard(key)
                self._anomaly.discard(key)
                self.stats["requests_shed"] += 1
                self.stats["dropped_cap"] += 1
                return
            if name in ("reject", "shed") or (name == "request"
                                              and ph == "X"):
                # Tree complete: a rejection/shed is a terminal instant, a
                # root span is the finalize. Flushable at the next drain.
                self._closed.add(key)
                self.stats["requests_closed"] += 1
            if is_anomaly_event(name, args):
                self._anomaly.add(key)
        self.events.append((name, cat, ph, ts, dur, wid, key, args))
        self._buffered[wid] = self._buffered.get(wid, 0) + 1
        if len(self.events) > self.peak_buffered:
            self.peak_buffered = len(self.events)

    def instant(self, name: str, cat: str, t: float, *, wid: int = 0,
                key: Optional[int] = None, args: Optional[dict] = None):
        self._record(name, cat, "i", t, 0.0, wid, key, args)

    def span(self, name: str, cat: str, t0: float, t1: float, *,
             wid: int = 0, key: Optional[int] = None,
             args: Optional[dict] = None):
        self._record(name, cat, "X", t0, max(t1 - t0, 0.0), wid, key, args)

    def counter(self, name: str, t: float, value: float, *,
                wid: int = 0) -> None:
        """One sample of a Perfetto counter track (``ph: "C"``) — e.g. the
        budget ledger's effective lambda or a worker's queue depth."""
        self._record(name, "counter", "C", t, 0.0, wid, None,
                     {"value": float(value)})

    def scoped(self, wid: int) -> "ScopedTrace":
        """A view stamping ``wid`` on every event (shared event log)."""
        return ScopedTrace(self, wid)

    # -- streaming drain ------------------------------------------------------

    def drain(self, force: bool = False) -> List[tuple]:
        """Remove and return the flushable events.

        Flushable = runtime-scope events (no request key) + events of
        *closed* request trees that survive sampling (anomalous trees are
        always kept, shed trees are always dropped). ``force=True`` also
        drains open trees (end of run) — unsampled, since an open tree
        never finished deciding its tail. Buffered memory after a drain is
        bounded by in-flight requests, not run length.
        """
        drop = set()
        if self.sampler is not None:
            drop = {k for k in self._closed
                    if k not in self._anomaly and not self.sampler.keep(k)}
            self.stats["requests_sampled_out"] += len(drop)
        out: List[tuple] = []
        kept: List[tuple] = []
        for e in self.events:
            key = e[_KEY]
            if key is None:
                out.append(e)
            elif key in self._shed:
                self.stats["dropped_cap"] += 1
            elif key in drop:
                self.stats["dropped_sampled"] += 1
            elif force or key in self._closed:
                out.append(e)
            else:
                kept.append(e)
        self.events = kept
        # Shed keys stay tracked (late events of a shed tree must keep
        # dropping); closed/anomaly bookkeeping for drained trees is done.
        self._closed.clear()
        self._anomaly = {k for k in self._anomaly if k not in drop}
        if force:
            self._anomaly.clear()
        self._buffered = {}
        for e in kept:
            self._buffered[e[_WID]] = self._buffered.get(e[_WID], 0) + 1
        return out

    @property
    def drop_stats(self) -> Dict[str, int]:
        return dict(self.stats)

    def absorb(self, events: Sequence[tuple]) -> None:
        """Fold a batch drained from a peer recorder with a *disjoint* key
        space (a follower built with ``key_base``): events are appended
        verbatim — keys, wids, and span-link args survive untouched — and
        their keys are marked closed + anomalous so this recorder's next
        drain flushes them unconditionally instead of re-sampling trees
        the peer already sampled."""
        for e in events:
            e = tuple(e)
            self.events.append(e)
            self.stats["events"] += 1
            key = e[_KEY]
            if key is not None:
                self._closed.add(key)
                self._anomaly.add(key)
            self._buffered[e[_WID]] = self._buffered.get(e[_WID], 0) + 1
        if len(self.events) > self.peak_buffered:
            self.peak_buffered = len(self.events)

    # -- rollup --------------------------------------------------------------

    def merge(self, other: "TraceRecorder") -> None:
        """Fold an independently-built recorder in (request keys re-based
        so two recorders that both started at key 0 cannot collide)."""
        base = self._next_key
        for e in other.events:
            key = e[_KEY]
            self.events.append(e if key is None else
                               e[:_KEY] + (key + base,) + e[_KEY + 1:])
        self._next_key = base + other._next_key

    # -- export --------------------------------------------------------------

    def chrome_trace(self, include_wall: bool = False) -> Dict:
        """Chrome trace-event JSON document (Perfetto-loadable).

        ``include_wall=False`` (the default) drops wall-clock categories so
        the document is a pure function of the seeded virtual-clock run.
        Timestamps are microseconds (virtual seconds * 1e6).
        """
        return build_trace_doc(self.events, label=self.label,
                               include_wall=include_wall)

    def to_json(self, include_wall: bool = False) -> str:
        """Canonical serialization — byte-comparable across replays."""
        return json.dumps(self.chrome_trace(include_wall=include_wall),
                          sort_keys=True, separators=(",", ":"))

    def save(self, path: str, include_wall: bool = False) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(include_wall=include_wall))

    @property
    def n_events(self) -> int:
        return len(self.events)


class ScopedTrace:
    """Worker-scoped view of a shared :class:`TraceRecorder`."""

    __slots__ = ("recorder", "wid")

    def __init__(self, recorder: TraceRecorder, wid: int):
        self.recorder = recorder
        self.wid = int(wid)

    def ensure_key(self, req) -> int:
        return self.recorder.ensure_key(req)

    def instant(self, name, cat, t, *, key=None, args=None):
        self.recorder._record(name, cat, "i", t, 0.0, self.wid, key, args)

    def span(self, name, cat, t0, t1, *, key=None, args=None):
        self.recorder._record(name, cat, "X", t0, max(t1 - t0, 0.0),
                              self.wid, key, args)

    def counter(self, name, t, value):
        self.recorder.counter(name, t, value, wid=self.wid)


# -- export helpers -----------------------------------------------------------


def build_trace_doc(events: Sequence[tuple], *, label: str = "run",
                    include_wall: bool = False,
                    other: Optional[dict] = None) -> Dict:
    """Build a Chrome trace-event document from raw event tuples.

    Shared by :meth:`TraceRecorder.chrome_trace` (whole buffer) and the
    streaming flusher (one drained batch per segment). Events are sorted by
    (ts, wid, arrival index) so the output is a pure function of the event
    set, and ``process_name`` metadata rows are emitted for every worker
    seen in *this* document.
    """
    out = []
    wids = set()
    order = sorted(range(len(events)),
                   key=lambda i: (events[i][_TS], events[i][_WID], i))
    for i in order:
        name, cat, ph, ts, dur, wid, key, args = events[i]
        if not include_wall and cat in WALL_CATS:
            continue
        wids.add(wid)
        ev = {
            "name": name, "cat": cat, "ph": ph,
            "ts": ts * 1e6, "pid": wid,
            "tid": 0 if key is None else key + 1,
        }
        if ph == "X":
            ev["dur"] = dur * 1e6
        if ph == "i":
            ev["s"] = "t"               # instant scope: thread
        if args:
            ev["args"] = args
        out.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": wid, "tid": 0,
             "args": {"name": f"worker {wid}"}}
            for wid in sorted(wids)]
    other_data = {"label": label, "deterministic": not include_wall}
    if other:
        other_data.update(other)
    return {
        "traceEvents": meta + out,
        "displayTimeUnit": "ms",
        "otherData": other_data,
    }


def trace_doc_to_json(doc: Dict) -> str:
    """Canonical serialization — byte-comparable across replays."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


# -- validation ---------------------------------------------------------------

_REQUIRED = ("name", "cat", "ph", "ts", "pid", "tid")


def validate_chrome_trace(doc) -> List[str]:
    """Schema problems of a Chrome trace-event document ([] = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["document must be a dict with a 'traceEvents' list"]
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        if ev.get("ph") == "M":
            continue
        for k in _REQUIRED:
            if k not in ev:
                problems.append(f"event {i} ({ev.get('name')}): missing {k!r}")
        if ev.get("ph") not in ("X", "i", "C"):
            problems.append(f"event {i}: unknown ph {ev.get('ph')!r}")
        if ev.get("ph") == "X" and not (
                isinstance(ev.get("dur"), (int, float)) and ev["dur"] >= 0):
            problems.append(f"event {i} ({ev.get('name')}): X without dur>=0")
        if ev.get("ph") == "C":
            args = ev.get("args")
            if not (isinstance(args, dict) and args and all(
                    isinstance(v, (int, float)) for v in args.values())):
                problems.append(f"event {i} ({ev.get('name')}): C counter "
                                "without numeric args")
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i}: non-numeric ts")
    return problems


def request_trees(doc) -> Dict[int, Dict]:
    """Group a trace's request-scope events into per-request trees.

    Returns ``{tid: {"root": event|None, "events": [...], "legs": [...],
    "admits": [...]}}`` over every tid > 0 (request scope), across all
    workers — a request that migrated between workers (crash reassignment,
    cascade re-admission in the plane) contributes events from several
    pids to one tree.
    """
    trees: Dict[int, Dict] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "M" or ev.get("tid", 0) == 0:
            continue
        t = trees.setdefault(ev["tid"], {"root": None, "events": [],
                                         "legs": [], "admits": []})
        t["events"].append(ev)
        if ev["name"] == "request" and ev["ph"] == "X":
            t["root"] = ev
        elif ev["name"] == "leg" and ev["ph"] == "X":
            t["legs"].append(ev)
        elif ev["name"] in ("admit", "readmit"):
            t["admits"].append(ev)
    for t in trees.values():
        t["legs"].sort(key=lambda e: e["ts"])
    return trees


def validate_span_tree(doc, eps_us: float = 0.5) -> List[str]:
    """Well-formedness of the per-request span trees ([] = well-formed).

    Every finalized request (a ``request`` root span) must cover
    admission -> legs -> finalize: at least one admit event, all events
    inside the root interval, completed roots with >= 1 leg span, legs
    time-ordered and non-overlapping, and per-leg queue_wait spans.

    Legs carrying a ``gen`` arg (span link) must resolve to a runtime-scope
    ``generate`` micro-batch span on the same worker whose interval lies
    inside the leg's. Legs without the arg are skipped — hand-built traces
    and pre-link documents stay valid.

    RPC flow links are validated fleet-wide: every client-side ``rpc``
    span must have a matching server-side span (same ``rpc`` link id) —
    a dangling client link is a validation error, since the transport
    only emits the client span after a successful reply. Unmatched
    *server* spans are fine (the reply can be lost in transit). Legs
    carrying an ``rpc`` arg (remote GENERATE dispatch) must resolve to a
    client span on the leg's own pid and a server span on the owning pid.
    """
    problems: List[str] = []
    gen_spans: Dict[Tuple[int, int], Dict] = {}
    rpc_client: Dict[int, Dict] = {}
    rpc_server: Dict[int, Dict] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X" or ev.get("tid", 0) != 0:
            continue
        if ev.get("name") == "generate":
            gen = (ev.get("args") or {}).get("gen")
            if gen is not None:
                gen_spans[(ev["pid"], gen)] = ev
        elif ev.get("name") == "rpc":
            args = ev.get("args") or {}
            link = args.get("rpc")
            if link is not None:
                side = rpc_client if args.get("side") == "client" \
                    else rpc_server
                side[link] = ev
    for link, ev in sorted(rpc_client.items()):
        if link not in rpc_server:
            problems.append(
                f"rpc {link}: client span on worker {ev['pid']} "
                f"(kind={((ev.get('args') or {}).get('kind'))!r}) has no "
                "matching server span — dangling flow link")
    for tid, t in sorted(request_trees(doc).items()):
        root = t["root"]
        if root is None:
            # Un-finalized request scope: only backpressure rejections and
            # SLO-class load shedding are allowed to stay rootless (those
            # requests never reached dispatch).
            names = {e["name"] for e in t["events"]}
            if names - {"reject"} and "shed" not in names:
                problems.append(f"request {tid}: events {sorted(names)} "
                                "without a 'request' root span")
            continue
        lo, hi = root["ts"] - eps_us, root["ts"] + root["dur"] + eps_us
        if not t["admits"]:
            problems.append(f"request {tid}: no admission event")
        for ev in t["events"]:
            end = ev["ts"] + ev.get("dur", 0.0)
            if ev["ts"] < lo or end > hi:
                problems.append(
                    f"request {tid}: {ev['name']} [{ev['ts']:.1f},"
                    f"{end:.1f}]us outside root [{lo:.1f},{hi:.1f}]us")
        root_args = root.get("args") or {}
        status = root_args.get("status")
        if status == "done" and not t["legs"] and not root_args.get("cached"):
            # Cache-served requests legitimately finish with zero legs —
            # the semantic cache is rung 0, no pool member ran.
            problems.append(f"request {tid}: done without a leg span")
        # Expiry/rescue consistency: a done root must never contain an
        # `expire` instant (the queue classifies rescues up front), and a
        # `rescued` instant only appears under a rescued root.
        if status == "done" and any(
                e["name"] == "expire" for e in t["events"]):
            problems.append(
                f"request {tid}: 'expire' instant under a done root")
        if (any(e["name"] == "rescued" for e in t["events"])
                and not root_args.get("rescued")):
            problems.append(
                f"request {tid}: 'rescued' instant under an un-rescued root")
        prev_end = None
        for leg in t["legs"]:
            if prev_end is not None and leg["ts"] < prev_end - eps_us:
                problems.append(f"request {tid}: overlapping leg spans")
            prev_end = leg["ts"] + leg["dur"]
            gen = (leg.get("args") or {}).get("gen")
            if gen is None:
                continue
            src = gen_spans.get((leg["pid"], gen))
            if src is None:
                problems.append(f"request {tid}: leg links gen={gen} but no "
                                f"generate span on worker {leg['pid']}")
                continue
            if (src["ts"] < leg["ts"] - eps_us or
                    src["ts"] + src["dur"] > prev_end + eps_us):
                problems.append(
                    f"request {tid}: linked generate span gen={gen} "
                    f"[{src['ts']:.1f},{src['ts'] + src['dur']:.1f}]us "
                    f"outside leg [{leg['ts']:.1f},{prev_end:.1f}]us")
            lm = (leg.get("args") or {}).get("member")
            gm = (src.get("args") or {}).get("member")
            if lm is not None and gm is not None and lm != gm:
                problems.append(f"request {tid}: leg member {lm!r} != "
                                f"linked generate member {gm!r}")
            rlink = (leg.get("args") or {}).get("rpc")
            if rlink is None:
                continue
            cli = rpc_client.get(rlink)
            if cli is None:
                problems.append(f"request {tid}: leg links rpc={rlink} but "
                                "no client rpc span")
            elif cli["pid"] != leg["pid"]:
                problems.append(
                    f"request {tid}: rpc={rlink} client span on worker "
                    f"{cli['pid']} != leg worker {leg['pid']}")
            if rlink not in rpc_server:
                problems.append(f"request {tid}: leg links rpc={rlink} but "
                                "no server rpc span")
        n_waits = sum(e["name"] == "queue_wait" for e in t["events"])
        if t["legs"] and n_waits < len(t["legs"]):
            problems.append(f"request {tid}: {len(t['legs'])} legs but only "
                            f"{n_waits} queue_wait spans")
    return problems


def trace_summary(doc) -> Dict:
    """Aggregate counts for quick inspection / tooling."""
    by_name: Dict[str, int] = {}
    by_cat: Dict[str, int] = {}
    wids = set()
    n = 0
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "M":
            continue
        n += 1
        by_name[ev["name"]] = by_name.get(ev["name"], 0) + 1
        by_cat[ev["cat"]] = by_cat.get(ev["cat"], 0) + 1
        wids.add(ev["pid"])
    trees = request_trees(doc)
    return {
        "events": n,
        "by_name": dict(sorted(by_name.items())),
        "by_cat": dict(sorted(by_cat.items())),
        "workers": sorted(wids),
        "requests": len(trees),
        "finalized": sum(t["root"] is not None for t in trees.values()),
    }
