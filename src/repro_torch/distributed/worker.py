"""One serving-plane worker: engine replica + scheduler + local online state.

The port of ``repro.distributed.worker``, with every handler of the
reference's, including those only a socket-mode follower receives
(``GENERATE``, ``LEDGER_OP``, ``TELEMETRY_REQ``, ``TRACE_REQ``,
``METRICS_REQ``, ``HELLO``), which ``--transport socket`` drives. In
process, an "engine replica" is a :class:`RoutedEngine` of its own over the
shared pool and router: the members' params are not copied; in a
follower process it holds only the members that process owns.

A worker is the unit of replication in the multi-worker plane: it owns its
own :class:`~repro_torch.serving.engine.RoutedEngine` instance (so router swaps
are per-worker and atomic), its own admission queue / micro-batching
scheduler / virtual clock (workers run concurrently in real deployments —
their virtual clocks advance independently), and — in online mode — a
follower :class:`~repro_torch.online.loop.OnlineAdapter` whose replay buffer is
the worker's local outcome log.

Since the message-passing refactor the worker is also a **transport
endpoint**: :meth:`bind` registers :meth:`handle` on a
:class:`~repro_torch.distributed.transport.Transport`, and every protocol
interaction (sync status, replay gather, router broadcast, plane step,
crash/rejoin, sharded generate, ledger ops, telemetry/trace dumps)
arrives as a :class:`~repro_torch.distributed.messages.Message`. The plain
methods below remain the implementation the handlers dispatch to — and
stay directly callable, which is what the in-process tests and benches
do through :class:`~repro_torch.distributed.transport.LocalTransport`'s
by-reference delivery.

Crash/rejoin models a worker process dying: queued and future requests must
be reassigned by the plane, and the in-memory online state (replay, staged
feedback) does not survive — a rejoining worker comes back empty and
catches up to the current router version from the leader.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from collections import deque

from repro_torch.distributed import messages as M
from repro_torch.distributed.messages import Message


class WorkerNode:
    def __init__(self, wid: int, engine, scheduler, adapter=None):
        self.wid = int(wid)
        self.engine = engine
        self.scheduler = scheduler
        self.adapter = adapter
        self.alive = True
        self.arrivals = deque()      # assigned, not-yet-arrived requests
        self.served: List = []       # completed requests, dispatch order
        self.swaps_accepted = 0
        self.swaps_rejected = 0
        self.crashes = 0
        self.transport = None
        # Socket mode: the controller-side worker fronts the real shared
        # budget ledger for follower LEDGER_OP messages. None = the
        # scheduler's own governor answers them.
        self.ledger = None
        # Socket mode: the follower's process-local TraceRecorder, drained
        # to the controller incrementally via TRACE_REQ (local mode shares
        # one recorder through the scheduler's scoped tracer instead).
        self.recorder = None
        # Socket mode: the follower's process-local MetricsRegistry,
        # scraped by the controller via METRICS_REQ (federated /metrics).
        self.registry = None

    # -- transport endpoint --------------------------------------------------

    def bind(self, transport) -> None:
        self.transport = transport
        transport.bind(self.wid, self.handle)

    def handle(self, msg: Message) -> Optional[dict]:
        """Service one protocol message; returns the reply payload.

        Kinds in :data:`~repro_torch.distributed.messages.RPC_SPAN_KINDS` emit a
        server-side ``rpc`` span around the handler (virtual-clock
        timestamps, so STEP spans carry their real virtual duration); the
        span's ``rpc`` arg is the request's seq — the same link id the
        transport stamps on the matching client span.
        """
        tracer = getattr(self.scheduler, "tracer", None)
        if tracer is None or msg.kind not in M.RPC_SPAN_KINDS:
            return self._handle(msg)
        t0 = self.clock.now
        out = self._handle(msg)
        tracer.span("rpc", "rpc", t0, self.clock.now,
                    args={"rpc": msg.seq, "kind": msg.kind,
                          "side": "server", "peer": int(msg.src)})
        return out

    def _handle(self, msg: Message) -> Optional[dict]:
        p = msg.payload
        kind = msg.kind
        if kind == M.SYNC_STATUS:
            return self.sync_status()
        if kind == M.REPLAY_SAMPLE:
            if self.adapter is None:
                return {"batch": None}
            return {"batch": self.adapter.replay.sample(
                int(p["n"]), recent_frac=float(p["recent_frac"]))}
        if kind == M.ROUTER_BCAST:
            return {"accepted": self.publish(p["router"]),
                    "version": self.router_version}
        if kind == M.CLEAR_BURST:
            if self.adapter is not None:
                self.adapter.pending_burst = False
            return None
        if kind == M.CACHE_INVAL:
            semcache = getattr(self.scheduler, "semcache", None)
            if semcache is not None:
                semcache.on_drift_alarm(float(p.get("now", 0.0)))
            return None
        if kind == M.ASSIGN:
            self.assign(p["reqs"])
            return {"n": len(p["reqs"])}
        if kind == M.NEXT_ACTION:
            return {"t": self.next_action_s()}
        if kind == M.STEP:
            served = self.step(float(p["t"]))
            return {"n_served": len(served), "now": self.clock.now}
        if kind == M.CRASH:
            return {"orphans": self.crash(float(p["t"]))}
        if kind == M.REJOIN:
            self.rejoin(float(p["t"]), p.get("router"),
                        p.get("replay_seed"))
            return {"version": self.router_version}
        if kind == M.TICK:
            if self.adapter is not None:
                self.adapter.tick(float(p["t"]))
            return None
        if kind == M.FINALIZE:
            return self.finalize(float(p["t"]),
                                 check_slo=bool(p.get("check_slo", True)))
        if kind == M.GENERATE:
            per_req = p.get("max_new_per_req")
            if per_req is not None:
                outs, costs = self.engine.generate_member(
                    int(p["member"]), p["prompts"],
                    max_new=int(p["max_new"]), max_new_per_req=per_req)
            else:
                outs, costs = self.engine.generate_member(
                    int(p["member"]), p["prompts"],
                    max_new=int(p["max_new"]))
            return {"outs": list(outs), "costs": costs}
        if kind == M.LEDGER_OP:
            return self.ledger_op(str(p["op"]), list(p.get("args", ())))
        if kind == M.TELEMETRY_REQ:
            return {"telemetry": self.telemetry,
                    "completed": self.telemetry.completed,
                    "served": len(self.served),
                    "swaps_accepted": self.swaps_accepted,
                    "swaps_rejected": self.swaps_rejected,
                    "crashes": self.crashes,
                    "version": self.router_version,
                    "now": self.clock.now}
        if kind == M.TRACE_REQ:
            # Incremental drain: flushable events (runtime scope + closed,
            # sampled request trees) leave this process now; ``force``
            # (end of run) also drains open trees.
            rec = self.recorder
            if rec is None:
                return {"events": [], "next_key": 0}
            return {"events": rec.drain(force=bool(p.get("force"))),
                    "next_key": rec._next_key}
        if kind == M.METRICS_REQ:
            if self.registry is None:
                return {"prom": ""}
            return {"prom": self.registry.prometheus(deterministic=False)}
        if kind == M.HELLO:
            return {"wid": self.wid}
        raise ValueError(f"worker {self.wid}: unknown message kind {kind!r}")

    # -- handler implementations ---------------------------------------------

    def sync_status(self) -> Dict:
        has_adapter = self.adapter is not None
        return {
            "wid": self.wid,
            "alive": self.alive,
            "version": self.router_version,
            "has_adapter": has_adapter,
            "pending_burst": bool(self.adapter.pending_burst)
            if has_adapter else False,
            "added": self.adapter.replay.added if has_adapter else 0,
            "distinct": len(self.adapter.replay) if has_adapter else 0,
            "now": self.clock.now,
        }

    def assign(self, reqs) -> None:
        """Merge newly assigned requests into the arrival backlog."""
        merged = sorted(list(self.arrivals) + list(reqs),
                        key=lambda r: (r.arrival_s, r.rid))
        self.arrivals = deque(merged)

    def finalize(self, t_end: float, *, check_slo: bool = True) -> Dict:
        """End-of-run bookkeeping: forced SLO evaluation + queue-level
        reject/expire counts folded into the telemetry snapshot."""
        slo = getattr(self.scheduler, "slo", None)
        if check_slo and slo is not None:
            slo.check(t_end, force=True)
        self.telemetry.rejected = self.queue.rejected
        self.telemetry.expired = self.queue.expired
        self.telemetry.shed = self.queue.shed
        return {"completed": self.telemetry.completed}

    def ledger_op(self, op: str, args: List) -> Dict:
        """Apply one budget-ledger operation for a remote scheduler.

        In socket mode the real :class:`SharedBudgetLedger` lives in the
        controller process (``self.ledger``); followers' ``LedgerClient``
        governors forward their update/record/read calls here so the
        $/window budget stays global.
        """
        gov = self.ledger if self.ledger is not None \
            else self.scheduler.governor
        if gov is None:
            raise ValueError(f"worker {self.wid}: no ledger to apply "
                             f"{op!r} to")
        allowed = {"update", "record", "utilization", "headroom",
                   "window_spend", "summary"}
        if op not in allowed:
            raise ValueError(f"unknown ledger op {op!r}")
        result = getattr(gov, op)(*args)
        return {"result": result, "lam": gov.lam,
                "last_action": getattr(gov, "last_action", None),
                "last_utilization": getattr(gov, "last_utilization", None)}

    # -- convenience ---------------------------------------------------------

    @property
    def clock(self):
        return self.scheduler.clock

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def telemetry(self):
        return self.scheduler.telemetry

    @property
    def router_version(self) -> int:
        return self.engine.router.version

    # -- router broadcast ----------------------------------------------------

    def publish(self, router) -> bool:
        """Atomically swap a broadcast router in; stale publishes rejected.

        The engine's ``swap_router`` enforces the version ordering — a
        worker that missed a broadcast can later accept a newer version,
        but a delayed older broadcast can never roll this worker back.
        """
        try:
            self.engine.swap_router(router)
        except ValueError:
            self.swaps_rejected += 1
            return False
        self.swaps_accepted += 1
        return True

    # -- plane event loop ----------------------------------------------------

    def next_action_s(self) -> float:
        """Earliest virtual time this worker can act (inf = nothing to do).

        Delegates to the scheduler's ``next_dispatch_s`` so the dispatch
        wake-time policy lives in one place for the solo and multi-worker
        paths alike.
        """
        if not self.alive:
            return float("inf")
        return self.scheduler.next_dispatch_s(
            self.arrivals[0].arrival_s if self.arrivals else None)

    def step(self, t: float) -> List:
        """Advance to ``t``, inject due arrivals, dispatch if ready."""
        self.clock.advance_to(t)
        while self.arrivals and self.arrivals[0].arrival_s <= self.clock.now:
            self.queue.offer(self.arrivals.popleft(), self.clock.now)
        self.scheduler.note_queue_depth()
        served = []
        if self.scheduler.should_dispatch(flush=not self.arrivals):
            served = self.scheduler.dispatch()
            self.served.extend(served)
        return served

    # -- crash / rejoin ------------------------------------------------------

    def crash(self, now: float) -> List:
        """Kill the worker; returns orphaned (queued + future) requests
        the plane must reassign. In-memory online state is lost."""
        self.alive = False
        self.crashes += 1
        orphans = list(self.queue.pop(self.queue.depth)) + list(self.arrivals)
        self.arrivals.clear()
        tracer = getattr(self.scheduler, "tracer", None)
        if tracer is not None:
            tracer.instant("worker_crash", "plane", now,
                           args={"orphans": len(orphans)})
        return orphans

    def rejoin(self, now: float, router=None,
               replay_seed: Optional[int] = None) -> None:
        """Restart after a crash: empty queue, fresh replay (nothing
        survived the process), catch-up swap to the current router."""
        self.alive = True
        self.clock.advance_to(now)
        if self.adapter is not None:
            seed = (self.wid + 1) * 7919 + self.crashes if replay_seed is None \
                else replay_seed
            self.adapter.reset_outcome_state(seed)
        if router is not None and router.version > self.engine.router.version:
            self.publish(router)
        tracer = getattr(self.scheduler, "tracer", None)
        if tracer is not None:
            tracer.instant("worker_rejoin", "plane", now,
                           args={"router_version": self.engine.router.version})
