"""Standard metric registrations for the serving subsystems.

The port's copy of ``repro.obs.wiring``, pure Python: the same events, series
and bytes as the reference's for the same inputs.

Every function here registers *callback* metrics: the registry holds
closures over the live objects and reads them at export time, so the
serving hot path pays nothing for being observable. The series names are
the stable external contract (``repro_torch.launch.serve --metrics-out``,
dashboards) and the reference's, byte for byte — keep them append-only.

Solo runs call :func:`register_scheduler_metrics` (+
:func:`register_governor_metrics` when a governor exists); the
multi-worker plane calls :func:`register_plane_metrics`, which labels
per-worker series with ``worker=<wid>`` and registers the shared ledger
and coordinator exactly once.
"""
from __future__ import annotations

import math

from repro_torch.obs.metrics import MetricsRegistry


def register_governor_metrics(reg: MetricsRegistry, governor, clock_fn,
                              labels=()) -> None:
    """Budget governor / shared ledger series. ``clock_fn() -> now`` supplies
    the virtual time the rolling window is evaluated at."""
    reg.gauge("budget_lam", "effective willingness-to-pay", labels=labels,
              fn=lambda: governor.lam)
    reg.gauge("budget_headroom", "budget slack in [0,1]", labels=labels,
              fn=lambda: governor.headroom(clock_fn()))
    reg.gauge("budget_utilization", "window spend / budget", labels=labels,
              fn=lambda: governor.utilization(clock_fn()))
    reg.counter("budget_total_spend", "cumulative $ spent", labels=labels,
                fn=lambda: governor.total_spend)
    reg.counter("budget_tightened_total", "lambda tighten steps",
                labels=labels, fn=lambda: governor.tightened)
    reg.counter("budget_relaxed_total", "lambda relax steps", labels=labels,
                fn=lambda: governor.relaxed)
    throttled = getattr(governor, "throttled", None)
    if throttled is not None:
        reg.counter("budget_throttled_total",
                    "ledger updates skipped by the throttle", labels=labels,
                    fn=lambda: governor.throttled)


def register_scheduler_metrics(reg: MetricsRegistry, sched,
                               labels=()) -> None:
    """Queue / telemetry / engine / adapter / cascade series of one
    scheduler (one worker). The governor is NOT registered here — it may
    be shared across workers (see :func:`register_plane_metrics`)."""
    queue, tel, engine = sched.queue, sched.telemetry, sched.engine
    clock_fn = lambda: sched.clock.now

    reg.gauge("queue_depth", "requests waiting for dispatch", labels=labels,
              fn=lambda: queue.depth)
    reg.counter("queue_admitted_total", "admissions", labels=labels,
                fn=lambda: queue.admitted)
    reg.counter("queue_rejected_total", "backpressure rejections",
                labels=labels, fn=lambda: queue.rejected)
    reg.counter("queue_expired_total", "deadline expiries", labels=labels,
                fn=lambda: queue.expired)
    reg.counter("queue_readmitted_total", "cascade re-admissions",
                labels=labels, fn=lambda: queue.readmitted)
    reg.counter("queue_shed_total", "SLO-class load-shedding drops",
                labels=labels, fn=lambda: queue.shed)

    reg.counter("requests_completed_total", "finalized requests",
                labels=labels, fn=lambda: tel.completed)
    reg.counter("score_batches_total", "router scoring rounds", labels=labels,
                fn=lambda: tel.score_batches)
    reg.counter("generate_calls_total", "generate micro-batches",
                labels=labels, fn=lambda: tel.generate_calls)
    reg.counter("spend_total", "cumulative $ across members", labels=labels,
                fn=lambda: tel.total_spend)
    reg.multi_gauge("member_served", "requests served per pool member",
                    "member", labels=labels,
                    fn=lambda: dict(zip(tel.member_names,
                                        (int(c) for c in tel.member_counts))))
    reg.histogram("queue_wait_s", "admission -> service (virtual s)",
                  labels=labels, fn=lambda: tel.queue_wait)
    reg.histogram("e2e_latency_s", "arrival -> finish (virtual s)",
                  labels=labels, fn=lambda: tel.e2e_latency)
    # Routing latency is measured wall time -> excluded from the
    # deterministic snapshot.
    reg.histogram("routing_latency_s", "score-batch wall latency",
                  labels=labels, wall=True, fn=lambda: tel.routing_latency)

    # Stub engines in tests/smokes may have no versioned router.
    if getattr(engine, "router", None) is not None:
        reg.gauge("router_version", "live router version on this engine",
                  labels=labels,
                  fn=lambda: getattr(engine.router, "version", 0))

    adapter = sched.adapter
    if adapter is not None:
        reg.counter("online_outcomes_total", "outcomes folded into replay",
                    labels=labels, fn=lambda: adapter.stats["outcomes"])
        reg.counter("online_explored_total", "exploration overrides",
                    labels=labels, fn=lambda: adapter.stats["explored"])
        reg.counter("online_router_swaps_total", "router publishes",
                    labels=labels, fn=lambda: adapter.stats["router_swaps"])
        reg.gauge("exploration_epsilon",
                  "effective epsilon (headroom-annealed)", labels=labels,
                  fn=lambda: adapter.policy.config.epsilon
                  * min(max(adapter.headroom(clock_fn()), 0.0), 1.0))
        if adapter.drift is not None:
            drift = adapter.drift
            reg.counter("drift_alarms_total", "drift alarms raised",
                        labels=labels, fn=lambda: drift.alarms)
            reg.gauge("drift_abnormal_streak",
                      "consecutive abnormal windows (alarm at patience)",
                      labels=labels, fn=lambda: drift.abnormal_streak)
            reg.gauge("drift_shift_z", "last window mean-shift z-score",
                      labels=labels,
                      fn=lambda: drift.last_stats.get("shift_z", math.nan))

    cascade = sched.cascade
    if cascade is not None:
        reg.counter("cascade_legs_total", "completed cascade legs",
                    labels=labels, fn=lambda: cascade.stats["legs"])
        reg.counter("cascade_escalations_total", "escalation decisions",
                    labels=labels, fn=lambda: cascade.stats["escalations"])
        reg.counter("cascade_headroom_blocked_total",
                    "escalations suppressed by the budget gate",
                    labels=labels,
                    fn=lambda: cascade.stats["headroom_blocked"])
        reg.gauge("cascade_escalation_rate", "escalations per finalized",
                  labels=labels, fn=lambda: cascade.escalation_rate)
        # Escalation rate by rung: escalations out of leg n / legs served
        # at leg n (the tail rung never escalates by construction).
        def _by_leg():
            esc = cascade.escalations_by_leg
            return {
                str(i + 1): ((esc[i] if i < len(esc) else 0) / served
                             if served else 0.0)
                for i, served in enumerate(sched.telemetry.leg_served)
            }
        reg.multi_gauge(
            "cascade_escalation_rate_by_leg",
            "P(escalate | completed leg n)", "leg", labels=labels,
            fn=_by_leg)

    semcache = getattr(sched, "semcache", None)
    if semcache is not None:
        reg.counter("semcache_hits_total", "cache answers served (rung 0)",
                    labels=labels, fn=lambda: semcache.stats["served"])
        reg.counter("semcache_misses_total", "lookups with no usable entry",
                    labels=labels, fn=lambda: semcache.stats["misses"])
        reg.counter("semcache_fallthroughs_total",
                    "hits the rung-0 policy escalated past",
                    labels=labels,
                    fn=lambda: semcache.stats["fallthroughs"])
        reg.counter("semcache_stale_hits_total",
                    "hits on drift-invalidated entries (never served)",
                    labels=labels,
                    fn=lambda: semcache.stats["stale_hits"])
        reg.counter("semcache_invalidations_total",
                    "entries invalidated by drift alarms", labels=labels,
                    fn=lambda: semcache.stats["invalidations"])
        reg.counter("semcache_evictions_total", "LRU evictions at capacity",
                    labels=labels, fn=lambda: semcache.stats["evicted"])
        reg.gauge("semcache_entries", "live cache entries", labels=labels,
                  fn=lambda: len(semcache))
        reg.gauge("semcache_hit_rate", "served / lookups", labels=labels,
                  fn=lambda: semcache.report()["hit_rate"])


def register_transport_metrics(reg: MetricsRegistry, transport,
                               labels=()) -> None:
    """RPC telemetry of one transport endpoint.

    Handles both stats shapes: an :class:`~repro_torch.distributed.transport.
    RpcStats` (LocalTransport) registers the ``rpc_*``
    series — per-kind/per-peer request counts, frame bytes, failure
    counters, in-flight gauge, and the wall-measured round-trip latency
    histogram; a plain fault-injection dict
    (:class:`~repro_torch.distributed.transport.FaultyTransport`) registers
    each counter as ``transport_fault_<key>_total`` and recurses into the
    wrapped inner transport.
    """
    from repro_torch.distributed.transport import RpcStats

    s = getattr(transport, "stats", None)
    if isinstance(s, dict):
        for k in sorted(s):
            reg.counter(f"transport_fault_{k}_total",
                        f"fault-injection events: {k}", labels=labels,
                        fn=lambda k=k: transport.stats.get(k, 0))
        inner = getattr(transport, "inner", None)
        if inner is not None:
            register_transport_metrics(reg, inner, labels=labels)
        return
    if not isinstance(s, RpcStats):
        return
    reg.multi_gauge("rpc_requests", "completed RPCs by message kind",
                    "kind", labels=labels, fn=lambda: dict(s.requests))
    reg.multi_gauge("rpc_peer_requests", "completed RPCs by peer wid",
                    "peer", labels=labels, fn=lambda: dict(s.peer_requests))
    reg.multi_gauge("rpc_bytes_out", "frame bytes sent by peer wid",
                    "peer", labels=labels, fn=lambda: dict(s.bytes_out))
    reg.multi_gauge("rpc_bytes_in", "frame bytes received by peer wid",
                    "peer", labels=labels, fn=lambda: dict(s.bytes_in))
    reg.counter("rpc_retries_total", "connect re-dials", labels=labels,
                fn=lambda: s.retries)
    reg.counter("rpc_timeouts_total", "request deadline misses",
                labels=labels, fn=lambda: s.timeouts)
    reg.counter("rpc_unreachable_total", "sends to unreachable peers",
                labels=labels, fn=lambda: s.unreachable)
    reg.counter("rpc_errors_total", "remote handler failures (ERROR replies)",
                labels=labels, fn=lambda: s.errors)
    reg.gauge("rpc_in_flight", "requests awaiting a reply", labels=labels,
              fn=lambda: s.in_flight)
    reg.histogram("rpc_latency_s", "RPC round-trip wall latency (all kinds)",
                  labels=labels, wall=True, fn=s.merged_latency)


def register_slo_metrics(reg: MetricsRegistry, tracker, clock_fn,
                         labels=()) -> None:
    """Burn-rate / firing-state series of an :class:`SLOTracker`.
    ``clock_fn() -> now`` supplies the virtual time the rolling windows
    are evaluated at."""
    reg.counter("slo_alerts_total", "SLO alert transitions", labels=labels,
                fn=lambda: tracker.alerts_total)
    reg.multi_gauge(
        "slo_burn_rate_short", "error-budget burn over the short window",
        "slo", labels=labels,
        fn=lambda: {s.name: s.burns(clock_fn())["short"]
                    for s in tracker.slos})
    reg.multi_gauge(
        "slo_burn_rate_long", "error-budget burn over the long window",
        "slo", labels=labels,
        fn=lambda: {s.name: s.burns(clock_fn())["long"]
                    for s in tracker.slos})
    reg.multi_gauge(
        "slo_firing", "1 = multi-window alert condition active", "slo",
        labels=labels,
        fn=lambda: {s.name: float(s.firing) for s in tracker.slos})


def register_stream_metrics(reg: MetricsRegistry, flusher,
                            labels=()) -> None:
    """Segment/drop accounting of an :class:`ObsFlusher` + its recorder."""
    reg.counter("obs_segments_total", "segment flushes written",
                labels=labels, fn=lambda: flusher.seq)
    rec = flusher.recorder
    if rec is not None:
        reg.gauge("obs_buffered_events", "events buffered in the recorder",
                  labels=labels, fn=lambda: rec.n_events)
        reg.gauge("obs_peak_buffered_events", "high-water buffered events",
                  labels=labels, fn=lambda: rec.peak_buffered)
        reg.counter("obs_dropped_sampled_total",
                    "events dropped by trace sampling", labels=labels,
                    fn=lambda: rec.stats["dropped_sampled"])
        reg.counter("obs_dropped_cap_total",
                    "events dropped by the per-worker cap", labels=labels,
                    fn=lambda: rec.stats["dropped_cap"])
        reg.counter("obs_requests_shed_total",
                    "request trees shed by the cap", labels=labels,
                    fn=lambda: rec.stats["requests_shed"])


def register_plane_metrics(reg: MetricsRegistry, plane) -> None:
    """Fleet-level series: per-worker scheduler metrics (labelled
    ``worker=<wid>``), worker liveness, the coordinator's sync counters,
    and the shared budget ledger (registered once)."""
    workers = sorted(plane.workers.values(), key=lambda w: w.wid)
    ledger = None
    for w in workers:
        labels = (("worker", w.wid),)
        # Remote-process workers (socket transport) are represented by
        # proxies without a local scheduler; their liveness/swap counters
        # are still mirrored and registered below.
        sched = getattr(w, "scheduler", None)
        if sched is not None:
            register_scheduler_metrics(reg, sched, labels=labels)
        reg.gauge("worker_alive", "1 = serving, 0 = crashed", labels=labels,
                  fn=lambda w=w: float(w.alive))
        reg.counter("worker_crashes_total", "crash events", labels=labels,
                    fn=lambda w=w: w.crashes)
        reg.counter("router_swaps_accepted_total", "broadcasts accepted",
                    labels=labels, fn=lambda w=w: w.swaps_accepted)
        reg.counter("router_swaps_rejected_total", "stale publishes rejected",
                    labels=labels, fn=lambda w=w: w.swaps_rejected)
        if sched is not None and sched.governor is not None:
            ledger = sched.governor

    if ledger is not None:
        # Shared ledger: evaluate the rolling window at the fleet's newest
        # virtual time (workers advance independently).
        clock_fn = lambda: max(w.clock.now for w in plane.workers.values())
        register_governor_metrics(reg, ledger, clock_fn)

    coord = plane.coordinator
    reg.counter("plane_reassigned_total", "orphaned requests reassigned",
                fn=lambda: plane.reassigned)
    reg.counter("sync_rounds_total", "coordinator sync rounds",
                fn=lambda: coord.stats["syncs"])
    reg.counter("sync_updates_total", "leader updates published",
                fn=lambda: coord.stats["updates"])
    reg.counter("sync_broadcasts_total", "router broadcasts",
                fn=lambda: coord.stats["broadcasts"])
    reg.counter("sync_bursts_total", "escalated drift bursts",
                fn=lambda: coord.stats["bursts"])
    reg.counter("sync_unreachable_total",
                "worker RPCs that found the peer unreachable",
                fn=lambda: coord.stats["unreachable"])
    reg.counter("sync_cache_invals_total",
                "semantic-cache invalidation broadcasts",
                fn=lambda: coord.stats["cache_invals"])
    reg.gauge("plane_alive_workers", "workers currently serving",
              fn=lambda: sum(w.alive for w in plane.workers.values()))
    register_transport_metrics(reg, coord.transport)
