"""Multi-worker serving plane: N micro-batching workers, one leader.

The port of ``repro.distributed.plane`` (pure Python): the same event
loop, so a seeded in-process run makes the reference's message sequence,
trace and rollups.

Requests are assigned round-robin across workers (a front-door load
balancer), every worker runs the continuous micro-batching loop from
:mod:`repro_torch.serving.scheduler` on its own virtual clock, and the
:class:`~repro_torch.distributed.coordinator.Coordinator` periodically runs the
replay-merge -> leader-update -> broadcast cycle.

Since the message-passing refactor the plane drives workers exclusively
through :class:`~repro_torch.distributed.messages.Message` traffic on the
coordinator's :class:`~repro_torch.distributed.transport.Transport` —
``ASSIGN`` / ``NEXT_ACTION`` / ``STEP`` / ``CRASH`` / ``REJOIN`` /
``TICK`` / ``FINALIZE``. Over
:class:`~repro_torch.distributed.transport.LocalTransport` the messages are
delivered by reference to in-process :class:`WorkerNode` endpoints —
the event sequence (and therefore every seeded replay) is bit-identical
to the pre-refactor shared-object plane. Over
:class:`~repro_torch.distributed.transport.SocketTransport` the same loop
drives real OS processes (see :mod:`repro_torch.distributed.host`); the
``workers`` list then holds :class:`~repro_torch.distributed.host.
RemoteWorkerProxy` mirrors that satisfy the reporting surface
(``telemetry``, ``router_version``, ``clock``) by RPC.

The event loop is deterministic: it always advances the worker with the
earliest next-action time (ties by worker id), fires sync rounds at fixed
virtual-time boundaries, and applies crash/rejoin scenario events in
timestamp order. A crashed worker's queued and future requests are
reassigned to the survivors; a rejoining worker comes back with empty
online state and catch-up swaps to the current router version. A worker
whose transport endpoint is unreachable (socket partition) is treated as
unable to act until the crash/rejoin machinery reconciles it.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence

from repro_torch.distributed import messages as M
from repro_torch.distributed.messages import Message
from repro_torch.distributed.transport import TransportError
from repro_torch.serving.telemetry import Telemetry


@dataclasses.dataclass(frozen=True)
class PlaneEvent:
    """A scenario event: ``kind`` is "crash" or "rejoin"."""
    t: float
    kind: str
    wid: int


class ServingPlane:
    def __init__(self, workers: List, coordinator, *,
                 sync_every_s: Optional[float] = None,
                 events: Sequence[PlaneEvent] = (), tracer=None,
                 flusher=None, fleet_drain=None):
        self.workers = {w.wid: w for w in workers}
        self.coordinator = coordinator
        self.transport = coordinator.transport
        self.sync_every_s = (coordinator.config.sync_every_s
                             if sync_every_s is None else sync_every_s)
        self.events = sorted(
            events, key=lambda e: (e.t, e.kind != "crash", e.wid))
        self.reassigned = 0
        self.ignored_events: List[PlaneEvent] = []
        self._stash: List = []   # orphans while no worker is alive
        # Observability (repro_torch.obs): the plane's tracer is the SHARED
        # TraceRecorder — workers hold worker-scoped views of it, the
        # coordinator stamps its events with the leader's wid, and
        # scenario events land here. One recorder means a request that
        # migrates between workers (crash reassignment) keeps one span
        # tree across pids. (Socket mode has per-process recorders
        # instead, merged by the controller at end of run.)
        self.tracer = tracer
        if tracer is not None and getattr(coordinator, "tracer", None) \
                is None:
            coordinator.tracer = tracer
        # RPC tracing: the transport emits client-side `rpc` spans for the
        # plane/coordinator protocol traffic. The event loop stamps
        # `transport.now` with the fleet's virtual time at every decision
        # point, so span timestamps are a pure function of the seeded
        # schedule (wall latency goes to `transport.stats`, not the trace).
        if tracer is not None and self.transport.tracer is None:
            self.transport.tracer = tracer
        # Socket mode: called at every sync boundary with the fleet
        # high-water virtual time — drains follower trace segments and
        # refreshes the federated /metrics snapshot between rounds.
        self.fleet_drain = fleet_drain
        # Streaming flusher (repro_torch.obs.stream.ObsFlusher): ticked at the
        # event loop's deterministic decision points on the fleet's
        # high-water virtual time — flush boundaries are a pure function
        # of the seeded schedule, so segment contents replay bit-identical.
        self.flusher = flusher

    # -- transport helpers ---------------------------------------------------

    def _request(self, wid: int, kind: str,
                 payload: Optional[dict] = None) -> Optional[dict]:
        try:
            rep = self.transport.request(
                Message(kind=kind, dst=wid, payload=payload or {}))
        except TransportError:
            return None
        return rep.payload

    # -- request assignment --------------------------------------------------

    def _alive(self) -> List:
        return [w for w in sorted(self.workers.values(), key=lambda w: w.wid)
                if w.alive]

    def _assign(self, reqs: Sequence) -> None:
        """Round-robin a time-sorted request list over alive workers."""
        alive = self._alive()
        if not alive:
            self._stash.extend(reqs)
            return
        buckets: Dict[int, List] = {w.wid: [] for w in alive}
        for i, r in enumerate(sorted(reqs, key=lambda r: (r.arrival_s, r.rid))):
            w = alive[i % len(alive)]
            buckets[w.wid].append(r)
        for w in alive:
            if buckets[w.wid]:
                rep = self._request(w.wid, M.ASSIGN,
                                    {"reqs": buckets[w.wid]})
                if rep is None:     # unreachable: hold for a rejoin
                    self._stash.extend(buckets[w.wid])

    # -- scenario events -----------------------------------------------------

    def _apply_event(self, e: PlaneEvent) -> None:
        w = self.workers[e.wid]
        self.transport.now = e.t
        if self.tracer is not None:
            self.tracer.instant("plane_event", "plane", e.t, wid=e.wid,
                                args={"kind": e.kind})
        if e.kind == "crash" and w.alive:
            rep = self._request(e.wid, M.CRASH, {"t": e.t})
            orphans = rep["orphans"] if rep is not None else []
            w.alive = False
            self.reassigned += len(orphans)
            self._assign(orphans)
        elif e.kind == "rejoin" and not w.alive:
            leader = self.coordinator.leader
            router = leader.engine.router if leader is not None else None
            rep = self._request(e.wid, M.REJOIN,
                                {"t": e.t, "router": router,
                                 "replay_seed": None})
            if rep is None:
                return              # still unreachable: stays down
            w.alive = True
            if self._stash:
                stash, self._stash = self._stash, []
                self._assign(stash)
        elif e.kind in ("crash", "rejoin"):
            # Crash of a dead worker / rejoin of a live one: the protocol
            # treats these as idempotent no-ops, but record them — a
            # misordered scenario (rejoin scheduled before its crash)
            # surfaces here instead of disappearing silently.
            self.ignored_events.append(e)
        else:
            raise ValueError(f"unknown plane event kind {e.kind!r}")

    # -- the deterministic event loop ----------------------------------------

    def _next_action(self, w) -> float:
        rep = self._request(w.wid, M.NEXT_ACTION)
        return float("inf") if rep is None else float(rep["t"])

    def run_trace(self, trace: Sequence) -> Dict:
        """Serve an open-loop trace across the worker fleet to completion."""
        ev = deque(self.events)
        t_start = min((w.clock.now for w in self.workers.values()),
                      default=0.0)
        self.transport.now = t_start
        self._assign(list(trace))
        next_sync = t_start + self.sync_every_s
        t_hi = t_start                  # fleet high-water virtual time
        while True:
            acts = [(self._next_action(w), w.wid) for w in self._alive()]
            acts = [a for a in acts if a[0] != float("inf")]
            t_next, wid = min(acts) if acts else (float("inf"), -1)
            t_ev = ev[0].t if ev else float("inf")
            if t_next == float("inf"):
                if ev:              # drain remaining scenario events
                    self._apply_event(ev.popleft())
                    continue
                break
            if t_ev <= t_next and t_ev <= next_sync:
                self._apply_event(ev.popleft())
                continue
            if next_sync <= t_next:
                self.coordinator.sync_round(next_sync)
                t_hi = max(t_hi, next_sync)
                next_sync += self.sync_every_s
                if self.fleet_drain is not None:
                    self.fleet_drain(t_hi)
                if self.flusher is not None:
                    self.flusher.maybe_flush(t_hi)
                continue
            self.transport.now = t_next
            rep = self._request(wid, M.STEP, {"t": t_next})
            w = self.workers[wid]
            if rep is not None and hasattr(w, "observe_step"):
                w.observe_step(rep)     # proxy mirrors clock/served counts
            t_hi = max(t_hi, t_next)
            if self.flusher is not None:
                self.flusher.maybe_flush(t_hi)

        t_end = max(w.clock.now for w in self.workers.values())
        self.transport.now = t_end
        for w in self._alive():
            self._request(w.wid, M.TICK, {"t": t_end})
        self.coordinator.sync_round(t_end)
        self.coordinator.converge()
        # Forced end-of-run SLO evaluation. In-process workers may SHARE
        # one tracker (the fleet-wide SLO view) — dedup by object id so a
        # run shorter than the check throttle still surfaces each alert
        # exactly once; remote proxies own per-process trackers and always
        # check.
        seen_slos: set = set()
        for w in self.workers.values():
            check_slo = True
            sched = getattr(w, "scheduler", None)
            if sched is not None:
                slo = getattr(sched, "slo", None)
                if slo is None or id(slo) in seen_slos:
                    check_slo = False
                else:
                    seen_slos.add(id(slo))
            self._request(w.wid, M.FINALIZE,
                          {"t": t_end, "check_slo": check_slo})
        return self.summary(t_end - t_start)

    # -- reporting -----------------------------------------------------------

    def rollup(self) -> Telemetry:
        return Telemetry.rollup(
            [w.telemetry for w in sorted(self.workers.values(),
                                         key=lambda w: w.wid)])

    def summary(self, duration_s: Optional[float] = None) -> Dict:
        merged = self.rollup()
        out = merged.summary(duration_s)
        out["n_workers"] = len(self.workers)
        out["alive_workers"] = len(self._alive())
        out["reassigned"] = self.reassigned
        out["ignored_events"] = [dataclasses.asdict(e)
                                 for e in self.ignored_events]
        out["router_versions"] = {
            w.wid: w.router_version for w in self.workers.values()}
        out["per_worker_completed"] = {
            w.wid: w.telemetry.completed for w in self.workers.values()}
        out["coordinator"] = dict(self.coordinator.stats)
        return out

    def report(self, duration_s: Optional[float] = None) -> str:
        merged = self.rollup()
        lines = [merged.report(duration_s)]
        versions = " ".join(
            f"w{w.wid}:v{w.router_version}{'' if w.alive else '(down)'}"
            for w in sorted(self.workers.values(), key=lambda w: w.wid))
        ignored = (f"  ignored events {len(self.ignored_events)}"
                   if self.ignored_events else "")
        lines.append(
            f"plane: {len(self._alive())}/{len(self.workers)} workers up  "
            f"versions {versions}  reassigned {self.reassigned}{ignored}")
        lines.append(self.coordinator.report())
        return "\n".join(lines)
