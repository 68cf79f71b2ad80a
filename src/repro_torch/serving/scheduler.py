"""Continuous micro-batching scheduler for the routed serving runtime.

The streaming pipeline the paper's router needs in deployment:

    traffic -> AdmissionQueue -> [score batch] -> per-member micro-batches
                                 (router_xattn       (coalesced generate
                                  CUDA kernel)        calls per pool member)

Each dispatch round drains up to ``score_batch`` requests from the queue,
scores them in ONE pass through the router (the fused cross-attention path
reuses the pool-side K~/V~ projections across rounds), then coalesces
same-member requests into generate micro-batches of at most ``max_batch``.
A round fires when the queue holds a full score batch, when the head
request has waited ``max_wait_s`` (latency bound under light load), or on
final flush — the standard continuous-batching trade-off.

Time is a first-class input: the scheduler runs against a :class:`SimClock`
so open-loop traces replay deterministically. Service time defaults to
measured wall time (real compute cost of the pool) but can be overridden
with a model for fully deterministic tests.

The port of ``repro.serving.scheduler``, a close copy. Its engine is the
port's :class:`~repro_torch.serving.engine.RoutedEngine`; the semantic
cache, when given, is :class:`~repro_torch.serving.semcache.SemanticCache`.
The ``adapter``/``cascade``/``tracer``/``slo``/``flusher``/``dispatcher``
hooks are the reference's duck-typed interfaces and default to ``None``:
the layers behind them (online, cascade, obs, the fleet) are later slices
of the port, which plug in here without another copy of this module.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.budget import BudgetGovernor
from repro_torch.serving.queue import DONE, AdmissionQueue, Request
from repro_torch.serving.telemetry import Telemetry


class SimClock:
    """Monotone virtual clock; the runtime never reads wall time directly."""

    def __init__(self, start: float = 0.0):
        self.now = start

    def advance_to(self, t: float) -> None:
        self.now = max(self.now, t)

    def advance(self, dt: float) -> None:
        self.now += max(dt, 0.0)


def default_service_model(score_us_per_req: float = 200.0,
                          generate_base_ms: float = 2.0,
                          generate_ms_per_req: float = 1.0):
    """Deterministic virtual service-time model for the simulator.

    Measured generate wall time depends on the host (seconds per call for
    the reduced configs on a CPU), which would stretch the virtual timeline
    far past any realistic budget window; this model gives the simulated
    deployment production-shaped service times (scoring ~us/request,
    generation ~ms/micro-batch) so budget windows, deadlines, and arrival
    rates compose sensibly. Pass
    ``service_time=None`` to the scheduler to use measured wall time instead.
    """
    def model(kind: str, n: int, wall_s: float) -> float:
        if kind == "score":
            return n * score_us_per_req * 1e-6
        return (generate_base_ms + n * generate_ms_per_req) * 1e-3
    return model


@dataclasses.dataclass
class SchedulerConfig:
    score_batch: int = 64      # max requests scored per dispatch round
    max_batch: int = 8         # max requests per member generate micro-batch
    max_wait_s: float = 0.02   # dispatch when head-of-line waited this long
    queue_capacity: int = 256


class MicroBatchScheduler:
    """Drives a stateless :class:`~repro_torch.serving.engine.RoutedEngine`.

    ``service_time(kind, n_requests, wall_s) -> virtual seconds`` (kind is
    ``"score"`` or ``"generate"``) lets tests and the simulator replace
    measured wall time with a deterministic model.
    """

    def __init__(self, engine, config: Optional[SchedulerConfig] = None,
                 *, governor: Optional[BudgetGovernor] = None,
                 queue: Optional[AdmissionQueue] = None,
                 telemetry: Optional[Telemetry] = None,
                 clock: Optional[SimClock] = None,
                 service_time: Optional[Callable[[str, int, float], float]]
                 = None,
                 adapter=None, cascade=None, tracer=None, slo=None,
                 flusher=None, semcache=None, dispatcher=None):
        self.engine = engine
        self.config = config or SchedulerConfig()
        self.queue = queue or AdmissionQueue(self.config.queue_capacity)
        self.telemetry = telemetry or Telemetry(
            [m.name for m in engine.pool])
        self.governor = governor
        self.clock = clock or SimClock()
        self.service_time = service_time
        # Observability (the obs layer): one tracer fans out to every hook the
        # scheduler owns — the queue's admission events, the cascade's
        # decision instants, the adapter's observe/update events, and the
        # engine's router-swap notifications. All emission sites are
        # ``if tracer is not None`` branches: with no tracer the runtime
        # does zero extra work.
        self.tracer = tracer
        if tracer is not None:
            self.queue.tracer = tracer
            if cascade is not None and getattr(cascade, "tracer", None) \
                    is None:
                cascade.tracer = tracer
            if adapter is not None and getattr(adapter, "tracer", None) \
                    is None:
                adapter.tracer = tracer
            if getattr(engine, "on_swap", None) is None:
                engine.on_swap = lambda version: tracer.instant(
                    "router_swap", "online", self.clock.now,
                    args={"version": version})
        # SLO monitors (the obs layer's SLOTracker): every finalized request
        # is observed once, and burn rates are re-evaluated at the end of
        # each dispatch round (the tracker throttles itself).
        self.slo = slo
        if slo is not None and slo.tracer is None:
            slo.tracer = tracer
        # SLO-class admission enforcement: when on, a firing burn-rate
        # alert sheds the queue's lowest slo_class at dispatch start
        # (opt-in via serve's --slo-class; off = identical behavior).
        self.slo_enforce = False
        # Streaming flusher (the obs layer's ObsFlusher): run_trace ticks
        # it on the virtual clock; the multi-worker plane drives its own.
        self.flusher = flusher
        # Perfetto counter tracks are emitted on value *change* only —
        # a flat series costs one event, not one per tick.
        self._ctr_depth: Optional[int] = None
        self._ctr_lam: Optional[float] = None
        # Online adaptation (the online layer's OnlineAdapter): overrides the
        # scoring-step argmax with the exploration policy and consumes
        # served outcomes after every dispatch round.
        self.adapter = adapter
        # Cascade escalation (the cascade layer's CascadeCoordinator): turns
        # completed legs into stop-vs-escalate decisions; escalated
        # requests are re-admitted at the queue head instead of finalized.
        self.cascade = cascade
        # Semantic answer cache (repro_torch.serving.semcache.SemanticCache):
        # rung 0 of the cascade ladder, consulted on the scoring pass's
        # shared q_emb before any scoring/generation. With a cascade
        # installed the cache borrows its policy (stop-vs-escalate on the
        # same reward math) and, when the adapter owns a drift detector,
        # registers its invalidation on that detector's alarm hooks.
        self.semcache = semcache
        if semcache is not None:
            if cascade is not None and semcache.policy is None:
                semcache.policy = cascade.policy
            adrift = getattr(adapter, "drift", None)
            if (adrift is not None and semcache.drift is None
                    and semcache.on_drift_alarm not in adrift.alarm_hooks):
                adrift.alarm_hooks.append(semcache.on_drift_alarm)
        # Sharded-pool dispatch (the fleet layer's PoolDispatcher):
        # when set, generate micro-batches go through ``dispatcher.
        # generate_member`` — members this worker owns run on the local
        # engine, any other member's batch is routed to its owning worker
        # over the plane's transport. None = every member is local.
        self.dispatcher = dispatcher
        # Engines that predate per-request cost accounting (test/bench
        # stubs) return one scalar $ per generate call and take no
        # ``max_new_per_req``; detect once and split evenly for them.
        gen = (engine.generate_member if dispatcher is None
               else dispatcher.generate_member)
        try:
            sig = inspect.signature(gen)
            self._gen_per_req = "max_new_per_req" in sig.parameters
        except (TypeError, ValueError):
            self._gen_per_req = False

    # -- one scheduling round -----------------------------------------------

    def should_dispatch(self, flush: bool = False) -> bool:
        if self.queue.depth == 0:
            return False
        if flush or self.queue.depth >= self.config.score_batch:
            return True
        # 1ns slack: admitted + max_wait can round to exactly `now`, making
        # the computed wait one ulp short of max_wait forever (livelock).
        return (self.queue.oldest_wait(self.clock.now)
                >= self.config.max_wait_s - 1e-9)

    def next_dispatch_s(self, next_arrival_s: Optional[float] = None) -> float:
        """Earliest virtual time a dispatch could be warranted.

        The wake-time counterpart of :meth:`should_dispatch` (same policy
        as :meth:`run_trace`'s inline wait computation — keep the three in
        step): dispatch immediately when a full score batch is queued or
        there is nothing left to wait for (flush); otherwise wake at the
        head-of-line wait bound or the next known arrival, whichever comes
        first. Returns inf when the queue is empty and no arrival is
        scheduled. Used by the multi-worker plane's event loop
        (the fleet layer's worker).
        """
        if self.queue.depth and (
                next_arrival_s is None
                or self.queue.depth >= self.config.score_batch):
            return self.clock.now
        cands = []
        if self.queue.depth:
            head = self.queue.peek_all()[0]
            cands.append(head.admitted_s + self.config.max_wait_s)
        if next_arrival_s is not None:
            cands.append(next_arrival_s)
        if not cands:
            return float("inf")
        return max(self.clock.now, min(cands))

    def _virtual_dt(self, kind: str, n: int, wall_s: float) -> float:
        if self.service_time is None:
            return wall_s
        return self.service_time(kind, n, wall_s)

    def note_queue_depth(self) -> None:
        """Sample queue depth into telemetry (+ a Perfetto counter track on
        change). The single depth-sampling entry point for every host loop
        (run_trace, the plane's worker steps)."""
        depth = self.queue.depth
        self.telemetry.record_queue_depth(self.clock.now, depth)
        if self.tracer is not None and depth != self._ctr_depth:
            self._ctr_depth = depth
            self.tracer.counter("queue_depth", self.clock.now, depth)

    def _cache_rung(self, batch, q_emb, lam, outcomes):
        """Cascade rung 0: serve eligible requests from the semantic cache.

        Consulted on the shared embedding pass before any scoring or
        generation. A *stop* verdict serves the cached answer at zero
        marginal cost and finalizes the request on the spot; a
        *fallthrough* (the policy expects a real rung to beat the cached
        answer) carries the cached answer as best-so-far into the ladder
        — keep-best semantics, escalating can only add cost, never lose
        the answer in hand. Returns (remaining batch, their q_emb rows,
        cache-served requests); cache-served outcome snapshots (charged
        the entry's ORIGINAL generation cost, so the adapter's cost head
        keeps training on real economics) are appended to ``outcomes``.
        """
        now = self.clock.now
        tracer = self.tracer
        cache = self.semcache
        # Cache-owned drift detector watches the full arrival stream
        # (no-op when invalidation rides the adapter's detector).
        cache.observe_queries(q_emb, now)
        for r, e in zip(batch, q_emb):
            r.q_emb = e
        names = [m.name for m in self.engine.pool]
        headroom = (self.cascade.headroom(now) if self.cascade is not None
                    else 1.0)
        eligible = [i for i, r in enumerate(batch)
                    if r.leg == 0 and r.forced_member < 0]
        hits = cache.match(q_emb[eligible]) if eligible else []
        hit_of = dict(zip(eligible, hits))
        keep, cache_served = [], []
        record_cache = self.telemetry.record_cache
        for i, r in enumerate(batch):
            if i not in hit_of:
                keep.append(i)
                continue
            if hit_of[i] is None:  # miss fast path: no verdict object
                cache.note_miss()
                record_cache("miss")
                keep.append(i)
                continue
            v = cache.decide(hit_of[i], lam, headroom=headroom)
            if not v.serve:
                if v.reason == "stale":
                    self.telemetry.record_cache("stale")
                    if tracer is not None:
                        tracer.instant(
                            "cache_stale", "cache", now, key=r.trace_key,
                            args={"dist": v.dist,
                                  "member": v.entry.member_name})
                else:
                    self.telemetry.record_cache("miss")
                if v.reason == "fallthrough" and self.cascade is not None:
                    mi = (names.index(v.entry.member_name)
                          if v.entry.member_name in names else -1)
                    if mi >= 0:
                        r.best_q = v.entry.quality
                        r.best_q_std = v.sigma
                        r.best_member = mi
                        r.best_observed = False
                        r.best_output = np.asarray(
                            v.entry.output)[: r.max_new]
                keep.append(i)
                continue
            entry = v.entry
            mi = (names.index(entry.member_name)
                  if entry.member_name in names else -1)
            r.service_start_s = now
            r.queued_s = now - r.arrival_s
            r.finish_s = now
            r.status = DONE
            r.member = mi
            r.output = np.asarray(entry.output)[: r.max_new]
            r.cost = 0.0
            r.best_q = entry.quality
            r.best_q_std = v.sigma
            r.best_member = mi
            r.best_observed = False
            r.best_output = r.output
            self.telemetry.finalize_request(r)
            self.telemetry.record_cache("hit")
            if tracer is not None:
                tracer.span("queue_wait", "queue", r.admitted_s, now,
                            key=r.trace_key, args={"leg": 0})
                tracer.instant(
                    "cache_hit", "cache", now, key=r.trace_key,
                    args={"dist": v.dist, "member": entry.member_name,
                          "q": entry.quality})
                tracer.span(
                    "request", "request", r.arrival_s, r.finish_s,
                    key=r.trace_key,
                    args={"status": "done", "legs": 0, "cached": True,
                          "member": entry.member_name,
                          "cum_cost": r.cum_cost})
            if self.slo is not None:
                self._observe_slo(r, missed=False)
            if self.cascade is not None:
                self.cascade.on_cache_served(r)
            if self.adapter is not None and mi >= 0:
                snap = r.snapshot_leg()
                snap.member = mi
                snap.cost = entry.cost
                outcomes.append(snap)
            cache_served.append(r)
        return [batch[i] for i in keep], q_emb[keep], cache_served

    def _cache_admit(self, r: Request) -> None:
        """Offer a finalized outcome to the semantic cache."""
        if (self.semcache is None or r.q_emb is None
                or not 0 <= r.member < len(self.engine.pool)):
            return
        quality = r.best_q
        if math.isnan(quality):
            if r.leg_quality:
                quality = r.leg_quality[-1]
            elif r.s_pred is not None:
                quality = float(r.s_pred[r.member])
            else:
                return
        # $ the delivered answer cost to produce: its own leg's charge
        # (future hits replay this on the adapter's cost axis).
        cost = r.cost
        if r.member in r.tried and r.leg_costs:
            i = len(r.tried) - 1 - r.tried[::-1].index(r.member)
            if i < len(r.leg_costs):
                cost = r.leg_costs[i]
        self.semcache.admit(
            r.q_emb, output=r.output,
            member_name=self.engine.pool[r.member].name,
            quality=float(quality), cost=float(cost), s_pred=r.s_pred,
            s_std_pred=r.s_std_pred, c_pred=r.c_pred)

    def _observe_slo(self, r: Request, *, missed: bool) -> None:
        quality = None
        if not math.isnan(r.best_q):
            quality = r.best_q
        elif r.leg_quality:
            quality = r.leg_quality[-1]
        self.slo.observe_request(
            r.finish_s, e2e_s=r.e2e_latency_s, missed=missed,
            quality=quality, cost=r.cum_cost if r.cum_cost else r.cost)

    def dispatch(self) -> List[Request]:
        """Expire, score once, coalesce, generate. Returns served requests.

        With a cascade coordinator installed, a completed generate is a
        *leg*, not necessarily the end of the request: the coordinator may
        re-admit the request at the queue head with a forced next member
        (escalation), and only stop decisions finalize. Every leg's cost
        is charged to the budget governor as it happens, so the ledger
        sees the cascade's cumulative spend.
        """
        served: List[Request] = []
        tracer = self.tracer
        if self.slo_enforce and self.slo is not None and self.queue.depth:
            # SLO-class enforcement: a firing burn-rate alert means the
            # error budget is burning too fast — shed the lowest service
            # class queued before spending capacity on it. Shed requests
            # are NOT observed into the tracker (they never consumed an
            # error budget; feeding them back would self-amplify).
            firing = self.slo.firing()
            if firing:
                self.queue.shed_lowest(self.clock.now, alerts=firing)
        for r in self.queue.expire(self.clock.now):
            if r.best_output is not None:
                # Deadline hit mid-cascade: the request already holds a
                # served answer — deliver best-so-far instead of expiring
                # work that was paid for. The queue already classified it
                # as rescued (no expire instant, no expired count).
                r.status = DONE
                r.output = r.best_output
                r.member = r.best_member
                # Close out queued time: the request sat in queue from its
                # last (re)admission until the deadline fired.
                wait_from = r.arrival_s if r.leg == 0 else r.admitted_s
                r.queued_s = ((0.0 if math.isnan(r.queued_s) else r.queued_s)
                              + (r.finish_s - wait_from))
                self.telemetry.finalize_request(r)
                if self.cascade is not None:
                    self.cascade.on_rescued(r)
                if tracer is not None:
                    args = {"status": "done", "legs": r.leg,
                            "rescued": True, "cum_cost": r.cum_cost}
                    if r.leg == 0:
                        # Zero-leg rescue: the best-so-far answer came
                        # from a cache fallthrough, not a served leg.
                        args["cached"] = True
                    tracer.span("request", "request", r.arrival_s,
                                r.finish_s, key=r.trace_key, args=args)
                if self.slo is not None:
                    self._observe_slo(r, missed=True)
                served.append(r)
            else:
                if tracer is not None:
                    tracer.span("request", "request", r.arrival_s,
                                r.finish_s, key=r.trace_key,
                                args={"status": "expired", "legs": r.leg})
                if self.slo is not None:
                    self._observe_slo(r, missed=True)
        # Hot pool membership can mutate the pool between rounds: re-sync
        # the telemetry member axis and re-derive the cascade's cost
        # ladder (a stale ladder can't escalate to a new member and may
        # still rank a removed one).
        self.telemetry.sync_members([m.name for m in self.engine.pool])
        if self.cascade is not None:
            router = getattr(self.engine, "router", None)
            if router is not None:
                self.cascade.policy.refresh(router)
        batch = self.queue.pop(self.config.score_batch)
        if not batch:
            if self.slo is not None:
                self.slo.check(self.clock.now)
            return served

        lam = self.engine.lam
        if self.governor is not None:
            lam = self.governor.update(self.clock.now)
            if tracer is not None:
                tracer.instant(
                    "governor", "budget", self.clock.now,
                    args={"lam": lam,
                          "action": self.governor.last_action,
                          "utilization": self.governor.last_utilization})
        if tracer is not None and lam != self._ctr_lam:
            self._ctr_lam = lam
            tracer.counter("budget_lam", self.clock.now, lam)
        self.telemetry.record_lambda(self.clock.now, lam)

        outcomes: List[Request] = []   # per-leg outcomes for the adapter
        t_score0 = self.clock.now
        t0 = time.perf_counter()
        q_emb = None
        if (self.semcache is not None or self.adapter is not None
                or self.cascade is not None):
            # One embedding pass shared between the cache rung, scoring,
            # and the outcome loop (replay / drift want the same q_emb
            # the router saw).
            q_emb = np.asarray(self.engine.embed([r.text for r in batch]))
        if self.semcache is not None:
            # Cascade rung 0: the semantic cache short-circuits eligible
            # requests *before* any scoring or generation.
            batch, q_emb, cache_served = self._cache_rung(
                batch, q_emb, lam, outcomes)
            served.extend(cache_served)
            if not batch:
                if self.adapter is not None:
                    if outcomes:
                        self.adapter.observe(outcomes, self.clock.now)
                    else:
                        self.adapter.tick(self.clock.now)
                if self.slo is not None:
                    self.slo.check(self.clock.now)
                return served
        if q_emb is not None:
            if self.cascade is not None:
                s_hat, s_std, c_hat = self.engine.score_emb_uncertainty(q_emb)
                self.cascade.note_scores(batch, s_hat, s_std, c_hat)
            else:
                s_hat, c_hat = self.engine.score_emb(q_emb)
            if self.adapter is not None:
                choices = self.adapter.choose(s_hat, c_hat, lam,
                                              self.clock.now)
                for r, e, ex in zip(batch, q_emb, self.adapter.last_explored):
                    r.q_emb = e
                    r.explored = bool(ex)
            else:
                choices = self.engine.choose(s_hat, c_hat, lam)
        else:
            s_hat, c_hat = self.engine.score_texts([r.text for r in batch])
            choices = self.engine.choose(s_hat, c_hat, lam)
        if self.semcache is not None and self.cascade is None:
            # Pin the belief rows cache admissions fall back on for entry
            # quality when there is no cascade to pin them (note_scores).
            for r, s, c in zip(batch, s_hat, c_hat):
                if r.s_pred is None:
                    r.s_pred = np.asarray(s)
                    r.c_pred = np.asarray(c)
        choices = np.asarray(choices)
        names = [m.name for m in self.engine.pool]
        for i, r in enumerate(batch):
            if r.forced_member >= 0:
                # Escalated leg: the cascade policy already picked the
                # ladder rung; the argmax/exploration choice is overridden.
                # The rung is resolved by member NAME only (hot pool
                # mutations shift indices — a positional lookup would
                # silently dispatch a different member); a rung whose name
                # is gone falls back to free routing — the request must
                # not be lost, and must not run an arbitrary member.
                if r.forced_member_name and r.forced_member_name in names:
                    choices[i] = names.index(r.forced_member_name)
                r.forced_member = -1
                r.forced_member_name = ""
        score_wall = time.perf_counter() - t0
        self.telemetry.record_score_batch(len(batch), score_wall)
        self.clock.advance(self._virtual_dt("score", len(batch), score_wall))
        if tracer is not None:
            # Stub engines in tests/smokes may have no versioned router.
            version = getattr(getattr(self.engine, "router", None),
                              "version", None)
            tracer.span("score_batch", "sched", t_score0, self.clock.now,
                        args={"n": len(batch), "router_version": version})
        for r in batch:
            r.service_start_s = self.clock.now
            # True queued time accumulates per leg: arrival -> first
            # service, then admitted -> service for every re-admitted leg
            # — earlier legs' *generation* time never counts as queueing.
            wait_from = r.arrival_s if r.leg == 0 else r.admitted_s
            r.queued_s = ((0.0 if math.isnan(r.queued_s) else r.queued_s)
                          + (self.clock.now - wait_from))
            if tracer is not None:
                tracer.span("queue_wait", "queue", r.admitted_s,
                            self.clock.now, key=r.trace_key,
                            args={"leg": r.leg + 1})

        for mi in range(len(self.engine.pool)):
            idx = [i for i, c in enumerate(choices) if int(c) == mi]
            for lo in range(0, len(idx), self.config.max_batch):
                chunk = [batch[i] for i in idx[lo:lo + self.config.max_batch]]
                max_new = max(r.max_new for r in chunk)
                t_gen0 = self.clock.now
                t0 = time.perf_counter()
                gen = (self.engine.generate_member
                       if self.dispatcher is None
                       else self.dispatcher.generate_member)
                if self.dispatcher is not None:
                    # Trace context for a possible remote hop: the frame
                    # carries the chunk head's request-tree key and the
                    # generate link id this micro-batch will record under.
                    self.dispatcher.trace_key = (
                        chunk[0].trace_key if chunk[0].trace_key >= 0
                        else None)
                    self.dispatcher.parent_span = (
                        self.telemetry.generate_calls + 1)
                if self._gen_per_req:
                    outs, cost = gen(
                        mi, [r.prompt for r in chunk], max_new=max_new,
                        max_new_per_req=[r.max_new for r in chunk])
                else:
                    outs, cost = gen(
                        mi, [r.prompt for r in chunk], max_new=max_new)
                gen_wall = time.perf_counter() - t0
                self.clock.advance(
                    self._virtual_dt("generate", len(chunk), gen_wall))
                # Per-request $ charges: engines price delivered work per
                # request (prefill + each request's own new tokens); legacy
                # scalar-cost engines (test/bench stubs) split evenly.
                cost_arr = np.asarray(cost, np.float64)
                if cost_arr.ndim == 0:
                    per_req = np.full(len(chunk),
                                      float(cost_arr) / len(chunk))
                else:
                    per_req = cost_arr
                cost = float(per_req.sum())
                if self.governor is not None:
                    self.governor.record(cost, self.clock.now)
                delivered = sum(min(len(o), r.max_new)
                                for o, r in zip(outs, chunk))
                self.telemetry.record_generate(mi, len(chunk), delivered, cost)
                # Span-link id: this worker's generate micro-batch sequence
                # number (unique per pid — telemetry is per-worker). Leg
                # spans carry the same id so tooling can jump from a
                # request's leg to the micro-batch that served it.
                gen_id = self.telemetry.generate_calls
                # Remote hop: the dispatcher exposes the GENERATE RPC's
                # link id (request seq) — attached to the generate and leg
                # spans so tooling can jump from a request's leg to the
                # client/server rpc span pair across pids.
                rpc_id = (None if self.dispatcher is None
                          else getattr(self.dispatcher, "last_rpc", None))
                if tracer is not None:
                    gargs = {"member": self.engine.pool[mi].name,
                             "n": len(chunk), "cost": cost, "gen": gen_id}
                    if rpc_id is not None:
                        gargs["rpc"] = rpc_id
                    tracer.span("generate", "sched", t_gen0, self.clock.now,
                                args=gargs)
                for r, o, per_req_cost in zip(chunk, outs, per_req):
                    per_req_cost = float(per_req_cost)
                    r.member = mi
                    r.output = np.asarray(o)[: r.max_new]
                    r.cost = per_req_cost
                    r.cum_cost += per_req_cost
                    r.leg += 1
                    r.tried.append(mi)
                    r.leg_costs.append(per_req_cost)
                    r.finish_s = self.clock.now
                    if tracer is not None:
                        largs = {"leg": r.leg,
                                 "member": self.engine.pool[mi].name,
                                 "cost": per_req_cost, "gen": gen_id}
                        if rpc_id is not None:
                            largs["rpc"] = rpc_id
                        tracer.span(
                            "leg", "request", r.service_start_s, r.finish_s,
                            key=r.trace_key, args=largs)
                    if self.cascade is None:
                        r.status = DONE
                        self._cache_admit(r)
                        self.telemetry.finalize_request(r)
                        if tracer is not None:
                            tracer.span(
                                "request", "request", r.arrival_s,
                                r.finish_s, key=r.trace_key,
                                args={"status": "done", "legs": r.leg,
                                      "member": self.engine.pool[mi].name,
                                      "cum_cost": r.cum_cost})
                        if self.slo is not None:
                            self._observe_slo(r, missed=False)
                        served.append(r)
                        outcomes.append(r)
                        continue
                    nxt = self.cascade.on_leg_complete(r, lam,
                                                       self.clock.now)
                    self.telemetry.record_leg(
                        r.leg, per_req_cost, r.leg_quality[-1],
                        r.e2e_latency_s)
                    # The adapter trains on each leg's true attribution
                    # (member/cost of the leg that ran), which the live
                    # request object won't keep: snapshot it. (Only the
                    # adapter consumes outcomes — skip the copies without
                    # one.)
                    if self.adapter is not None:
                        outcomes.append(r.snapshot_leg())
                    if nxt is not None:
                        self.telemetry.record_escalation()
                        r.forced_member = nxt
                        r.forced_member_name = self.engine.pool[nxt].name
                        self.queue.offer_front(r, self.clock.now)
                        continue
                    r.status = DONE
                    if r.best_output is not None:
                        # Keep-best semantics: deliver the best leg's
                        # answer; cum_cost still charges every leg.
                        r.output = r.best_output
                        r.member = r.best_member
                    self._cache_admit(r)
                    self.telemetry.finalize_request(r)
                    if tracer is not None:
                        name = (self.engine.pool[r.member].name
                                if 0 <= r.member < len(self.engine.pool)
                                else str(r.member))
                        tracer.span(
                            "request", "request", r.arrival_s, r.finish_s,
                            key=r.trace_key,
                            args={"status": "done", "legs": r.leg,
                                  "member": name, "cum_cost": r.cum_cost})
                    if self.slo is not None:
                        self._observe_slo(r, missed=False)
                    served.append(r)
        if self.adapter is not None:
            if outcomes:
                # observe() also ticks: staged (delayed-feedback) outcomes
                # whose scores have landed flush on the same round.
                self.adapter.observe(outcomes, self.clock.now)
            else:
                self.adapter.tick(self.clock.now)
        if self.slo is not None:
            self.slo.check(self.clock.now)
        return served

    # -- open-loop trace replay ---------------------------------------------

    def run_trace(self, trace: Sequence[Request]) -> Dict:
        """Replay an open-loop arrival trace to completion.

        Arrivals are injected at their trace times regardless of service
        progress (open loop); the virtual clock jumps between arrival,
        wait-deadline, and service events. Returns the telemetry summary.
        """
        pending = deque(sorted(trace, key=lambda r: r.arrival_s))
        t_start = self.clock.now
        while pending or self.queue.depth:
            while pending and pending[0].arrival_s <= self.clock.now:
                self.queue.offer(pending.popleft(), self.clock.now)
            self.note_queue_depth()
            if self.flusher is not None:
                self.flusher.maybe_flush(self.clock.now)
            if self.should_dispatch(flush=not pending):
                self.dispatch()
                continue
            nxt = []
            if pending:
                nxt.append(pending[0].arrival_s)
            if self.queue.depth:
                head = self.queue.peek_all()[0]
                nxt.append(head.admitted_s + self.config.max_wait_s)
            nxt_t = min(nxt)
            if nxt_t <= self.clock.now:
                # No future event to wait for (float rounding): the only way
                # this happens is a queued head at its wait bound — serve it.
                self.dispatch()
                continue
            self.clock.advance_to(nxt_t)
        if self.adapter is not None:
            # Final flush: staged outcomes whose feedback landed by the end
            # of the trace still commit (later ones expire when the stage
            # has a timeout configured, else stay pending).
            self.adapter.tick(self.clock.now)
        if self.slo is not None:
            # Forced end-of-trace evaluation: a run shorter than the check
            # throttle must still surface its alert transitions.
            self.slo.check(self.clock.now, force=True)
        self.telemetry.rejected = self.queue.rejected
        self.telemetry.expired = self.queue.expired
        self.telemetry.shed = self.queue.shed
        return self.telemetry.summary(self.clock.now - t_start)
