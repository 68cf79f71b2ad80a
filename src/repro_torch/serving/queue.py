"""Admission queue for the streaming serving runtime.

The port's own copy of ``repro.serving.queue`` (pure Python and numpy).

Open-loop traffic lands here before the micro-batching scheduler drains it.
Admission control is explicit: a bounded queue exerts *backpressure* by
rejecting arrivals when full (the client-visible 429), and per-request
*deadlines* expire requests that waited too long to be worth serving
(routing latency budgets in the RouterBench setting are milliseconds; a
request that missed its deadline only wastes pool capacity).

Everything is driven by an externally supplied clock value ``now`` — the
queue itself never reads wall time, which keeps the runtime deterministic
under the simulator's virtual clock and testable without sleeps.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np

_REQUEST_IDS = itertools.count()

# Request lifecycle states.
PENDING = "pending"    # admitted, waiting in queue
DONE = "done"          # served; ``output`` holds the generated tokens
REJECTED = "rejected"  # backpressure: queue was full at arrival
EXPIRED = "expired"    # deadline passed before service started
SHED = "shed"          # dropped by SLO-class load shedding


@dataclasses.dataclass
class Request:
    """One routed generation request flowing through the runtime."""

    text: str                          # prompt text (what the router scores)
    prompt: np.ndarray                 # token ids for the chosen member
    max_new: int = 8
    arrival_s: float = 0.0             # trace arrival time (virtual clock)
    deadline_s: Optional[float] = None # absolute; None = never expires
    rid: int = dataclasses.field(default_factory=lambda: next(_REQUEST_IDS))
    # Observability identity: assigned by the TraceRecorder in admission
    # order (dense, deterministic across replays — unlike ``rid``, whose
    # process-global counter shifts between in-process runs). -1 = no
    # tracer has seen this request.
    trace_key: int = -1
    # Service class for SLO-aware load shedding: higher = more important.
    # When a burn-rate alert fires, the scheduler sheds queued requests of
    # the LOWEST class present first (0 = best-effort default).
    slo_class: int = 0

    # Filled in by the runtime.
    status: str = PENDING
    member: int = -1                   # routed pool member index (last leg)
    admitted_s: float = float("nan")
    service_start_s: float = float("nan")
    finish_s: float = float("nan")
    # True accumulated queue time: the scheduler adds each leg's wait
    # (arrival -> first service, then admitted -> service per re-leg) at
    # service start. ``nan`` = never served by the scheduler.
    queued_s: float = float("nan")
    cost: float = 0.0                  # $ of the LAST leg served
    output: Optional[np.ndarray] = None
    # Online-adaptation bookkeeping: the scoring-pass embedding (reused by
    # the replay buffer / drift detector) and whether exploration overrode
    # the reward argmax for this request.
    q_emb: Optional[np.ndarray] = None
    explored: bool = False
    # Multi-leg cascade lifecycle (the cascade layer). A request completing a
    # leg whose outcome triggers escalation is re-admitted at elevated
    # priority instead of finalized; these fields carry the cascade state
    # across legs. ``cum_cost`` is what cascade-aware reward accounting
    # charges — the SUM of every leg's cost, never just the last one.
    leg: int = 0                       # completed legs
    cum_cost: float = 0.0              # $ across ALL legs
    tried: List[int] = dataclasses.field(default_factory=list)
    leg_costs: List[float] = dataclasses.field(default_factory=list)
    leg_quality: List[float] = dataclasses.field(default_factory=list)
    forced_member: int = -1            # escalation target (-1 = route freely)
    forced_member_name: str = ""       # resolves the target across hot pool
    #                                    mutations (index shifts); "" = by index
    finalized: bool = False            # telemetry completion guard
    # Best-answer-so-far under keep-best escalation semantics.
    best_q: float = float("nan")
    best_q_std: float = 0.0
    best_member: int = -1
    best_observed: bool = False        # best_q is feedback, not an estimate
    best_output: Optional[np.ndarray] = None
    # Router belief rows pinned at the last scoring pass (cascade policy
    # inputs): per-member quality mean / ensemble std / predicted cost.
    s_pred: Optional[np.ndarray] = None
    s_std_pred: Optional[np.ndarray] = None
    c_pred: Optional[np.ndarray] = None

    @property
    def queue_wait_s(self) -> float:
        """Total time spent *queued*, summed across legs.

        The scheduler accumulates each leg's wait into ``queued_s`` at
        service start; earlier legs' generation time never counts as
        queueing (it used to: arrival -> final-leg service start folded
        every prior leg's service into "queue wait"). Requests that never
        went through the scheduler (hand-built telemetry inputs) fall
        back to the single-leg definition.
        """
        if not np.isnan(self.queued_s):
            return self.queued_s
        return self.service_start_s - self.arrival_s

    @property
    def e2e_latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    def snapshot_leg(self) -> "Request":
        """Frozen per-leg outcome copy with a fresh rid.

        The online loop observes every *leg* as its own outcome (the
        adapter learns from both the cheap try and the escalation), but the
        request object itself stays in flight and its ``member``/``cost``
        mutate on the next leg — and staged delayed feedback is keyed by
        rid, which must be unique per outcome. The per-leg lists are
        copied (the live request keeps appending to them); array fields
        are shared (never mutated in place).
        """
        return dataclasses.replace(
            self, rid=next(_REQUEST_IDS), status=DONE,
            tried=list(self.tried), leg_costs=list(self.leg_costs),
            leg_quality=list(self.leg_quality))


class AdmissionQueue:
    """Bounded FIFO with deadline expiry and admission counters."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._items: Deque[Request] = deque()
        self.admitted = 0
        self.rejected = 0
        self.expired = 0
        self.readmitted = 0
        self.shed = 0
        # Optional trace hook (the obs layer): admission/rejection/expiry are
        # queue-owned lifecycle transitions, so their events are emitted
        # here. The scheduler installs the tracer.
        self.tracer = None

    @property
    def depth(self) -> int:
        return len(self._items)

    def offer(self, req: Request, now: float) -> bool:
        """Admit ``req`` if there is room; reject (backpressure) otherwise."""
        if len(self._items) >= self.capacity:
            req.status = REJECTED
            self.rejected += 1
            if self.tracer is not None:
                self.tracer.instant("reject", "queue", now,
                                    key=self.tracer.ensure_key(req),
                                    args={"depth": len(self._items)})
            return False
        req.admitted_s = now
        self._items.append(req)
        self.admitted += 1
        if self.tracer is not None:
            self.tracer.instant("admit", "queue", now,
                                key=self.tracer.ensure_key(req),
                                args={"depth": len(self._items)})
        return True

    def offer_front(self, req: Request, now: float) -> None:
        """Re-admit an escalated leg at the HEAD of the queue.

        Escalated requests are in-flight work with sunk cost: making them
        queue behind fresh arrivals would stack a second full queue wait
        onto their latency, and rejecting them under backpressure would
        throw away a served answer. They therefore jump the FIFO and are
        exempt from the capacity bound (the request was already admitted
        once; re-admission never grows the number of live requests).
        """
        req.status = PENDING
        req.admitted_s = now
        self._items.appendleft(req)
        self.readmitted += 1
        if self.tracer is not None:
            self.tracer.instant("readmit", "queue", now,
                                key=self.tracer.ensure_key(req),
                                args={"leg": req.leg,
                                      "member": req.forced_member_name
                                      or str(req.forced_member)})

    def expire(self, now: float) -> List[Request]:
        """Drop queued requests whose deadline has passed.

        Rescue-aware: a request holding a best-so-far answer
        (``best_output``, mid-cascade) is *rescued*, not expired — the
        scheduler will finalize it with the answer in hand. It leaves the
        queue through the same returned list but keeps ``PENDING`` status,
        emits a ``rescued`` instant (not ``expire``), and never touches
        the ``expired`` counter — so traces and counters agree with the
        request's actual fate instead of flip-flopping through an expiry
        the scheduler immediately rewrites.
        """
        survivors: Deque[Request] = deque()
        dropped: List[Request] = []
        for req in self._items:
            if req.deadline_s is not None and req.deadline_s < now:
                req.finish_s = now
                dropped.append(req)
                if req.best_output is not None:
                    if self.tracer is not None:
                        self.tracer.instant(
                            "rescued", "queue", now,
                            key=self.tracer.ensure_key(req),
                            args={"leg": req.leg,
                                  "deadline_s": req.deadline_s})
                else:
                    req.status = EXPIRED
                    self.expired += 1
                    if self.tracer is not None:
                        self.tracer.instant(
                            "expire", "queue", now,
                            key=self.tracer.ensure_key(req),
                            args={"deadline_s": req.deadline_s})
            else:
                survivors.append(req)
        self._items = survivors
        return dropped

    def shed_lowest(self, now: float,
                    alerts: Sequence[str] = ()) -> List[Request]:
        """SLO-class-aware load shedding: drop every queued request of the
        LOWEST ``slo_class`` present.

        Called by the scheduler when a burn-rate alert fires: best-effort
        load is sacrificed first so higher classes keep their error
        budget. Escalated requests holding a best-so-far answer are never
        shed — they carry sunk cost and a servable answer (same rationale
        as deadline rescue). Each shed emits a ``shed`` trace instant and
        counts once; returns the dropped requests.
        """
        sheddable = [r for r in self._items if r.best_output is None]
        if not sheddable:
            return []
        lo = min(r.slo_class for r in sheddable)
        survivors: Deque[Request] = deque()
        dropped: List[Request] = []
        for req in self._items:
            if req.best_output is None and req.slo_class == lo:
                req.status = SHED
                req.finish_s = now
                self.shed += 1
                dropped.append(req)
                if self.tracer is not None:
                    self.tracer.instant("shed", "queue", now,
                                        key=self.tracer.ensure_key(req),
                                        args={"slo_class": lo,
                                              "alerts": list(alerts)})
            else:
                survivors.append(req)
        self._items = survivors
        return dropped

    def pop(self, n: int) -> List[Request]:
        """Dequeue up to ``n`` requests in arrival order."""
        out = []
        while self._items and len(out) < n:
            out.append(self._items.popleft())
        return out

    def oldest_wait(self, now: float) -> float:
        """Seconds the head-of-line request has waited (0 when empty)."""
        if not self._items:
            return 0.0
        return now - self._items[0].admitted_s

    def peek_all(self) -> Sequence[Request]:
        return tuple(self._items)
