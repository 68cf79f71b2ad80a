"""The port's observability layer on the CPU, against the JAX reference.

The reference's own cases (``tests/test_obs.py``, ``tests/test_obs_stream.py``)
are written out against the port's classes: the recorder and its streaming
drain, the validators, the metrics registry and its exporters, the traced
scheduler on this file's own fake engine, the kernel profiler on CPU tensors,
the metrics server, the sampler, the flusher, rolling windows, burn-rate SLOs,
the SLO tracker and the bounded telemetry series. No module of either package
is patched, and every test that installs the port's kernel profiler removes
it again in a ``finally``; no test installs the reference's.

Then the two packages are held to each other byte for byte: the same seeded
event sequences through both recorders, registries and flushers; the traced
fake-engine scheduler run and ``tools/obs_smoke.py``'s streaming cascade
scenario, each driven through one helper that takes the package's classes;
the smoke pool with the semantic cache (``test_torch_trace.py``'s set-up)
traced in both packages. Last, the serve entry point with the obs flags,
twice, gives the same bytes.
"""
import json
import os

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro_torch.kernels import ops as kops
from repro_torch.obs import (
    KernelProfiler,
    MetricsRegistry,
    MetricsServer,
    ObsFlusher,
    TraceRecorder,
    TraceSampler,
    WALL_CATS,
    concat_dir,
    is_anomaly_event,
    register_scheduler_metrics,
    request_trees,
    trace_summary,
    validate_chrome_trace,
    validate_span_tree,
)
from repro_torch.obs.slo import (
    BurnRateSLO,
    RollingWindow,
    SLOTracker,
    SpendBurnSLO,
    build_slo_tracker,
)
from repro_torch.obs.stream import segment_paths
from repro_torch.serving.queue import Request
from repro_torch.serving.scheduler import MicroBatchScheduler, SchedulerConfig
from repro_torch.serving.telemetry import BoundedSeries, Telemetry


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, so that parallel test
    workers do not each start one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def req(text="q", arrival=0.0, deadline=None, n_prompt=4, max_new=2):
    return Request(text=text, prompt=np.zeros(n_prompt, np.int32),
                   max_new=max_new, arrival_s=arrival, deadline_s=deadline)


class FakeMember:
    def __init__(self, name, cost_rate):
        self.name = name
        self.cost_rate = cost_rate


class FakeEngine:
    """Static-score engine (no router) — exercises the tracer's stub-engine
    guards alongside the span plumbing."""

    def __init__(self, cost_rates=(1.0, 10.0), quality=(0.5, 1.0)):
        self.pool = [FakeMember(f"m{i}", c) for i, c in enumerate(cost_rates)]
        self.quality = np.asarray(quality, np.float64)
        self.lam = 100.0

    def score_texts(self, texts):
        b = len(texts)
        s = np.tile(self.quality, (b, 1))
        c = np.tile([m.cost_rate for m in self.pool], (b, 1))
        return s, c

    def choose(self, s_hat, c_hat, lam=None):
        lam = self.lam if lam is None else lam
        return np.argmax(s_hat * np.exp(-c_hat / lam), axis=-1)

    def generate_member(self, mi, prompts, max_new=8):
        outs = [np.zeros(max_new, np.int32) for _ in prompts]
        return outs, self.pool[mi].cost_rate * len(prompts)


def run_traced_sched(n=12):
    rec = TraceRecorder(label="test")
    # Fixed virtual service times: with service_time=None the clock would
    # advance by measured wall time and the trace could not replay
    # bit-identically.
    sched = MicroBatchScheduler(
        FakeEngine(), SchedulerConfig(score_batch=4, max_batch=4),
        service_time=lambda kind, n_, wall: 1e-3,
        tracer=rec.scoped(0))
    reqs = [req(text=str(i), arrival=i * 1e-3) for i in range(n)]
    summary = sched.run_trace(reqs)
    return rec, sched, summary


# ---------------------------------------------------------------------------
# TraceRecorder
# ---------------------------------------------------------------------------

class TestTraceRecorder:
    def test_chrome_export_structure(self):
        rec = TraceRecorder(label="unit")
        rec.instant("admit", "queue", 0.001, key=rec.next_key())
        rec.span("request", "request", 0.001, 0.005, key=0,
                 args={"status": "done"})
        rec.span("score_batch", "sched", 0.002, 0.003)
        doc = rec.chrome_trace()
        assert validate_chrome_trace(doc) == []
        evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
        meta = [e for e in doc["traceEvents"] if e.get("ph") == "M"]
        assert len(evs) == 3 and len(meta) == 1
        # ts in microseconds; request-scoped events on tid key+1, runtime
        # scope on tid 0.
        admit = next(e for e in evs if e["name"] == "admit")
        assert admit["ts"] == pytest.approx(1000.0) and admit["tid"] == 1
        batch = next(e for e in evs if e["name"] == "score_batch")
        assert batch["tid"] == 0
        root = next(e for e in evs if e["name"] == "request")
        assert root["dur"] == pytest.approx(4000.0)

    def test_wall_categories_excluded_from_deterministic_export(self):
        rec = TraceRecorder()
        rec.span("kernel:pairwise_l2", "kernel", 0.0, 0.1)
        rec.instant("admit", "queue", 0.0, key=rec.next_key())
        assert "kernel" in WALL_CATS
        names = {e["name"] for e in rec.chrome_trace()["traceEvents"]
                 if e.get("ph") != "M"}
        assert names == {"admit"}
        names_wall = {e["name"]
                      for e in rec.chrome_trace(include_wall=True)
                      ["traceEvents"] if e.get("ph") != "M"}
        assert "kernel:pairwise_l2" in names_wall

    def test_ensure_key_dense_admission_order(self):
        rec = TraceRecorder()
        reqs = [req(text=str(i)) for i in range(3)]
        assert [rec.ensure_key(r) for r in reqs] == [0, 1, 2]
        # Idempotent on re-sight (cascade re-admission).
        assert rec.ensure_key(reqs[1]) == 1
        assert rec._next_key == 3

    def test_canonical_json_byte_stable(self):
        def build():
            rec = TraceRecorder(label="x")
            rec.instant("a", "queue", 0.25, key=rec.next_key(),
                        args={"depth": 3})
            rec.span("b", "sched", 0.25, 0.5)
            return rec.to_json()
        assert build() == build()

    def test_scoped_views_share_one_log(self):
        rec = TraceRecorder()
        w0, w1 = rec.scoped(0), rec.scoped(1)
        k = rec.next_key()
        w0.instant("admit", "queue", 0.0, key=k)
        w1.span("leg", "request", 0.1, 0.2, key=k)
        doc = rec.chrome_trace()
        pids = {e["pid"] for e in doc["traceEvents"] if e.get("ph") != "M"}
        assert pids == {0, 1}
        # Both workers' events land in one request tree (same tid).
        trees = request_trees(doc)
        assert len(trees) == 1 and len(trees[k + 1]["events"]) == 2
        # Process metadata for both workers.
        meta_pids = {e["pid"] for e in doc["traceEvents"]
                     if e.get("ph") == "M"}
        assert meta_pids == {0, 1}

    def test_merge_rebases_keys(self):
        a, b = TraceRecorder(), TraceRecorder()
        ra, rb = req(text="a"), req(text="b")
        a.instant("admit", "queue", 0.0, key=a.ensure_key(ra))
        b.instant("admit", "queue", 0.0, key=b.ensure_key(rb))
        a.merge(b)
        keys = sorted(e[6] for e in a.events)
        assert keys == [0, 1]
        assert a._next_key == 2


# ---------------------------------------------------------------------------
# Validators
# ---------------------------------------------------------------------------

class TestValidators:
    def test_schema_catches_malformed_events(self):
        doc = {"traceEvents": [
            {"name": "x", "cat": "c", "ph": "X", "ts": 0.0, "pid": 0,
             "tid": 1},                                   # X without dur
            {"name": "y", "cat": "c", "ph": "Z", "ts": 0.0, "pid": 0,
             "tid": 0},                                   # unknown ph
            {"cat": "c", "ph": "i", "ts": 0.0, "pid": 0, "tid": 0},  # no name
        ]}
        problems = validate_chrome_trace(doc)
        assert len(problems) >= 3

    def test_span_tree_catches_leg_outside_root(self):
        rec = TraceRecorder()
        k = rec.next_key()
        rec.instant("admit", "queue", 0.0, key=k)
        rec.span("request", "request", 0.0, 0.1, key=k,
                 args={"status": "done", "legs": 1})
        rec.span("queue_wait", "queue", 0.0, 0.01, key=k, args={"leg": 1})
        rec.span("leg", "request", 0.5, 0.6, key=k,
                 args={"leg": 1, "member": "m0"})   # outside the root span
        assert validate_span_tree(rec.chrome_trace())

    def test_span_tree_accepts_wellformed(self):
        rec = TraceRecorder()
        k = rec.next_key()
        rec.instant("admit", "queue", 0.0, key=k)
        rec.span("queue_wait", "queue", 0.0, 0.01, key=k, args={"leg": 1})
        rec.span("leg", "request", 0.01, 0.05, key=k,
                 args={"leg": 1, "member": "m0"})
        rec.span("request", "request", 0.0, 0.05, key=k,
                 args={"status": "done", "legs": 1})
        assert validate_span_tree(rec.chrome_trace()) == []


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------

class TestMetricsRegistry:
    def test_owned_and_callback_metrics(self):
        reg = MetricsRegistry()
        c = reg.counter("reqs_total", "requests")
        c.inc()
        c.inc(2)
        g = reg.gauge("depth", "queue depth")
        g.set(7)
        state = {"v": 3}
        cb = reg.gauge("live", "callback", fn=lambda: state["v"])
        snap = reg.snapshot()
        assert snap["reqs_total"]["value"] == 3.0
        assert snap["depth"]["value"] == 7.0
        assert snap["live"]["value"] == 3.0
        state["v"] = 9   # callbacks read live state at export time
        assert reg.snapshot()["live"]["value"] == 9.0
        with pytest.raises(TypeError):
            cb.set(1)

    def test_duplicate_registration_rejected(self):
        reg = MetricsRegistry()
        reg.counter("x", labels=(("worker", "0"),))
        reg.counter("x", labels=(("worker", "1"),))  # distinct labels: ok
        with pytest.raises(ValueError):
            reg.counter("x", labels=(("worker", "0"),))

    def test_deterministic_snapshot_excludes_wall(self):
        reg = MetricsRegistry()
        reg.counter("steady", "deterministic")
        reg.gauge("wall_g", "wall-clock", wall=True, fn=lambda: 1.0)
        full = reg.snapshot()
        det = reg.snapshot(deterministic=True)
        assert "wall_g" in full and "wall_g" not in det
        assert "steady" in det

    def test_histogram_snapshot_and_multigauge(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat_s", "latency")
        for v in (0.01, 0.02, 0.04):
            h.observe(v)
        reg.multi_gauge("rate_by_leg", "per-rung", "leg",
                        fn=lambda: {"1": 0.5, "2": 0.25})
        snap = reg.snapshot()
        hs = snap["lat_s"]
        assert hs["count"] == 3 and hs["min"] == 0.01 and hs["max"] == 0.04
        assert hs["min"] <= hs["p50"] <= hs["max"]
        assert snap['rate_by_leg{leg="1"}']["value"] == 0.5
        assert snap['rate_by_leg{leg="2"}']["value"] == 0.25

    def test_prometheus_exposition(self):
        reg = MetricsRegistry()
        reg.counter("reqs_total", "served requests",
                    labels=(("worker", "0"),)).inc(5)
        h = reg.histogram("lat_s", "latency")
        h.observe(0.01)
        h.observe(0.5)
        text = reg.prometheus()
        assert "# TYPE reqs_total counter" in text
        assert "# HELP reqs_total served requests" in text
        assert 'reqs_total{worker="0"} 5' in text
        assert "# TYPE lat_s histogram" in text
        assert "lat_s_count 2" in text
        assert "lat_s_sum 0.51" in text
        assert 'le="+Inf"} 2' in text
        # Buckets cumulative and ending at the total count.
        bucket_counts = [int(line.rsplit(" ", 1)[1])
                         for line in text.splitlines()
                         if line.startswith("lat_s_bucket")]
        assert bucket_counts == sorted(bucket_counts)
        assert bucket_counts[-1] == 2


# ---------------------------------------------------------------------------
# Traced scheduler (single worker)
# ---------------------------------------------------------------------------

class TestTracedScheduler:
    def test_span_tree_covers_every_request(self):
        rec, sched, summary = run_traced_sched(n=12)
        doc = rec.chrome_trace()
        assert validate_chrome_trace(doc) == []
        assert validate_span_tree(doc) == []
        summ = trace_summary(doc)
        assert summ["requests"] == 12
        assert summ["finalized"] == summary["completed"] == 12
        for t in request_trees(doc).values():
            assert t["root"] is not None
            assert t["root"]["args"]["status"] == "done"
            assert len(t["legs"]) == 1 and len(t["admits"]) == 1

    def test_replay_bit_identity(self):
        j1 = run_traced_sched(n=12)[0].to_json()
        j2 = run_traced_sched(n=12)[0].to_json()
        assert j1 == j2

    def test_untraced_run_has_no_tracer_state(self):
        sched = MicroBatchScheduler(
            FakeEngine(), SchedulerConfig(score_batch=4, max_batch=4))
        assert sched.tracer is None and sched.queue.tracer is None
        summary = sched.run_trace([req(text=str(i), arrival=i * 1e-3)
                                   for i in range(6)])
        assert summary["completed"] == 6

    def test_reject_and_expire_traced(self):
        rec = TraceRecorder()
        sched = MicroBatchScheduler(
            FakeEngine(),
            SchedulerConfig(score_batch=4, max_batch=4, queue_capacity=2),
            tracer=rec.scoped(0))
        # Burst of simultaneous arrivals against a 2-deep queue.
        reqs = [req(text=str(i), arrival=0.0) for i in range(5)]
        sched.run_trace(reqs)
        names = [e[0] for e in rec.events]
        assert names.count("reject") == 3
        # Rejected requests have no root span but are visible in the tree
        # grouping as reject-only leaves.
        doc = rec.chrome_trace()
        assert validate_span_tree(doc) == []

    def test_scheduler_metrics_match_telemetry(self):
        rec = TraceRecorder()
        reg = MetricsRegistry()
        sched = MicroBatchScheduler(
            FakeEngine(), SchedulerConfig(score_batch=4, max_batch=4),
            tracer=rec.scoped(0))
        register_scheduler_metrics(reg, sched)
        sched.run_trace([req(text=str(i), arrival=i * 1e-3)
                         for i in range(10)])
        snap = reg.snapshot(deterministic=True)
        assert snap["requests_completed_total"]["value"] == 10
        assert snap["queue_admitted_total"]["value"] == 10
        assert snap["e2e_latency_s"]["count"] == 10
        assert snap["spend_total"]["value"] == pytest.approx(
            sched.telemetry.total_spend)
        # Deterministic snapshot is replay-stable as JSON.
        assert json.loads(reg.to_json(deterministic=True)) == snap


# ---------------------------------------------------------------------------
# Kernel profiler
# ---------------------------------------------------------------------------

class TestKernelProfiler:
    def test_profiler_hooks_pairwise_l2(self):
        rec = TraceRecorder()
        prof = KernelProfiler(tracer=rec)
        kops.set_kernel_profiler(prof)
        try:
            x = torch.from_numpy(np.random.default_rng(0).normal(
                size=(8, 4)).astype(np.float32))
            c = torch.from_numpy(np.random.default_rng(1).normal(
                size=(3, 4)).astype(np.float32))
            out = kops.pairwise_l2(x, c).numpy()
        finally:
            kops.set_kernel_profiler(None)
        assert out.shape == (8, 3)
        assert prof.calls["pairwise_l2"] == 1
        assert prof.elements["pairwise_l2"] == 8
        assert prof.hists["pairwise_l2"].count == 1
        # The span is wall-clock: kernel category, excluded by default.
        kernel_events = [e for e in rec.events if e[1] == "kernel"]
        assert len(kernel_events) == 1
        det = rec.chrome_trace()["traceEvents"]
        assert not any(e.get("cat") == "kernel" for e in det)
        summ = prof.summary()["pairwise_l2"]
        assert summ["calls"] == 1 and summ["p50_us"] > 0
        assert "pairwise_l2" in prof.report()

    def test_uninstalled_profiler_is_passthrough(self):
        assert kops.get_kernel_profiler() is None
        x = torch.zeros((4, 4))
        c = torch.zeros((2, 4))
        assert kops.pairwise_l2(x, c).shape == (4, 2)

    def test_register_metrics(self):
        prof = KernelProfiler()
        with prof.annotate("router_xattn_pool", batch=64):
            pass
        reg = MetricsRegistry()
        prof.register_metrics(reg)
        snap = reg.snapshot()   # wall metrics: full snapshot only
        assert snap['kernel_calls_total{op="router_xattn_pool"}'][
            "value"] == 1
        assert snap['kernel_elements_total{op="router_xattn_pool"}'][
            "value"] == 64
        assert reg.snapshot(deterministic=True) == {}


class TestMetricsServer:
    """HTTP scrape endpoint over a live registry (ephemeral port)."""

    def _registry(self):
        reg = MetricsRegistry()
        reg.counter("reqs_total", "requests").inc(5)
        state = {"depth": 2}
        reg.gauge("queue_depth", "live depth", fn=lambda: state["depth"])
        return reg, state

    def _get(self, url):
        import urllib.request

        with urllib.request.urlopen(url, timeout=10.0) as resp:
            return resp.status, resp.headers.get("Content-Type"), \
                resp.read().decode()

    def test_prometheus_and_json_endpoints(self):
        reg, state = self._registry()
        with MetricsServer(reg) as srv:
            assert srv.port != 0          # ephemeral port was bound
            status, ctype, body = self._get(srv.url)
            assert status == 200 and ctype.startswith("text/plain")
            assert "# TYPE reqs_total counter" in body
            assert "reqs_total 5" in body
            # Gauges read their callbacks at scrape time.
            state["depth"] = 9
            _, _, body = self._get(srv.url)
            assert "queue_depth 9" in body
            status, ctype, body = self._get(
                f"http://127.0.0.1:{srv.port}/metrics.json")
            assert status == 200 and ctype == "application/json"
            assert json.loads(body)["reqs_total"]["value"] == 5.0
            assert srv.scrapes == 3

    def test_unknown_path_404(self):
        import urllib.error
        import urllib.request

        reg, _ = self._registry()
        with MetricsServer(reg) as srv:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/nope", timeout=10.0)
            assert ei.value.code == 404
            assert srv.scrapes == 0

    def test_requires_registry_and_stop_idempotent(self):
        with pytest.raises(ValueError):
            MetricsServer(None)
        reg, _ = self._registry()
        srv = MetricsServer(reg)
        port = srv.start()
        assert srv.start() == port        # second start is a no-op
        srv.stop()
        srv.stop()                        # idempotent


def run_streaming(out_dir, *, n=24, rate=0.25, head=4, cap=None,
                  scrape_every=0.002, tight_deadlines=(), slo=None):
    """One seeded streaming run: recorder + sampler (+cap) + flusher."""
    rec = TraceRecorder(label="stream-test",
                        sampler=TraceSampler(rate, seed=0, head=head),
                        max_buffered_per_worker=cap)
    flusher = ObsFlusher(out_dir, recorder=rec, scrape_every_s=scrape_every,
                         label="stream-test")
    sched = MicroBatchScheduler(
        FakeEngine(), SchedulerConfig(score_batch=8, max_batch=4),
        service_time=lambda kind, n_, wall: 1e-3,
        tracer=rec.scoped(0), slo=slo, flusher=flusher)
    reqs = []
    for i in range(n):
        deadline = 0.002 if i in tight_deadlines else None
        reqs.append(req(text=str(i), arrival=i * 1e-4, deadline=deadline))
    summary = sched.run_trace(reqs)
    flusher.finalize(sched.clock.now)
    return rec, flusher, sched, summary


# ---------------------------------------------------------------------------
# TraceSampler properties
# ---------------------------------------------------------------------------

class TestTraceSampler:
    @given(st.integers(0, 5000), st.floats(0.0, 1.0))
    @settings(max_examples=60, deadline=None)
    def test_keep_is_pure_function_of_seed_key_rate(self, key, rate):
        a = TraceSampler(rate, seed=7, head=0)
        b = TraceSampler(rate, seed=7, head=0)
        assert a.keep(key) == b.keep(key)

    @given(st.integers(0, 5000))
    @settings(max_examples=60, deadline=None)
    def test_keep_monotone_in_rate(self, key):
        """A request kept at a lower rate is kept at every higher rate —
        raising --trace-sample only ever adds trees, never swaps them."""
        rates = [0.0, 0.1, 0.25, 0.5, 0.9, 1.0]
        kept = [TraceSampler(r, seed=3, head=0).keep(key) for r in rates]
        assert kept == sorted(kept)   # False* then True*

    @given(st.integers(0, 64))
    @settings(max_examples=40, deadline=None)
    def test_head_always_kept(self, head):
        s = TraceSampler(0.0, seed=0, head=head)
        assert all(s.keep(k) for k in range(head))
        assert not any(s.keep(k) for k in range(head, head + 50))

    def test_rate_extremes(self):
        assert TraceSampler(1.0, head=0).keep_set(range(100)) == set(
            range(100))
        assert TraceSampler(0.0, head=0).keep_set(range(100)) == set()

    def test_keep_fraction_tracks_rate(self):
        for rate in (0.1, 0.25, 0.5, 0.75):
            frac = len(TraceSampler(rate, seed=0, head=0).keep_set(
                range(4000))) / 4000
            assert abs(frac - rate) < 0.03

    def test_seed_changes_keep_set(self):
        keys = range(200)
        a = TraceSampler(0.5, seed=0, head=0).keep_set(keys)
        b = TraceSampler(0.5, seed=1, head=0).keep_set(keys)
        assert a != b

    def test_invalid_rate_rejected(self):
        with pytest.raises(ValueError):
            TraceSampler(1.5)

    def test_anomaly_event_detection(self):
        assert is_anomaly_event("readmit", None)
        assert is_anomaly_event("expire", None)
        assert is_anomaly_event("request", {"status": "expired"})
        assert is_anomaly_event("request", {"status": "done",
                                            "rescued": True})
        assert not is_anomaly_event("request", {"status": "done"})
        assert not is_anomaly_event("admit", None)


# ---------------------------------------------------------------------------
# Recorder streaming semantics (drain / cap / accounting)
# ---------------------------------------------------------------------------

class TestRecorderStreaming:
    def close_tree(self, rec, key, t0):
        rec.instant("admit", "queue", t0, key=key)
        rec.span("leg", "request", t0, t0 + 0.01, key=key,
                 args={"leg": 1, "member": "m0"})
        rec.span("queue_wait", "queue", t0, t0 + 0.001, key=key,
                 args={"leg": 1})
        rec.span("request", "request", t0, t0 + 0.01, key=key,
                 args={"status": "done", "legs": 1})

    def test_drain_moves_closed_trees_only(self):
        rec = TraceRecorder()
        k0, k1 = rec.next_key(), rec.next_key()
        self.close_tree(rec, k0, 0.0)
        rec.instant("admit", "queue", 0.5, key=k1)   # open tree
        rec.span("score_batch", "sched", 0.0, 0.01)  # runtime scope
        out = rec.drain()
        names = [e[0] for e in out]
        assert names.count("request") == 1 and "score_batch" in names
        assert rec.n_events == 1        # k1's admit still buffered
        # Second drain with force flushes the open tree too.
        out2 = rec.drain(force=True)
        assert [e[0] for e in out2] == ["admit"] and rec.n_events == 0

    def test_sampling_drops_with_accounting_anomaly_kept(self):
        rec = TraceRecorder(sampler=TraceSampler(0.0, head=0))
        k_plain, k_anom = rec.next_key(), rec.next_key()
        self.close_tree(rec, k_plain, 0.0)
        # Anomalous tree: expired root.
        rec.instant("admit", "queue", 1.0, key=k_anom)
        rec.span("request", "request", 1.0, 1.5, key=k_anom,
                 args={"status": "expired", "legs": 0})
        out = rec.drain()
        keys = {e[6] for e in out}
        assert keys == {k_anom}
        assert rec.stats["requests_sampled_out"] == 1
        assert rec.stats["dropped_sampled"] == 4
        assert rec.n_events == 0

    def test_cap_sheds_whole_trees_and_late_events(self):
        rec = TraceRecorder(max_buffered_per_worker=6)
        keys = [rec.next_key() for _ in range(4)]
        for i, k in enumerate(keys):
            rec.instant("admit", "queue", i * 0.1, key=k)
            rec.span("queue_wait", "queue", i * 0.1, i * 0.1 + 0.01, key=k,
                     args={"leg": 1})
        # 8 events recorded against cap 6: trees opened after the cap was
        # hit are shed whole.
        assert rec.stats["requests_shed"] >= 1
        shed = set(rec._shed)
        assert shed
        # Late events of a shed tree keep dropping.
        before = rec.n_events
        rec.span("request", "request", 0.0, 1.0, key=next(iter(shed)),
                 args={"status": "done", "legs": 1})
        assert rec.n_events == before
        assert rec.stats["dropped_cap"] >= 2

    def test_event_conservation_law(self):
        """recorded == drained + still-buffered + dropped (cap + sampled)."""
        rec = TraceRecorder(sampler=TraceSampler(0.3, seed=1, head=2),
                            max_buffered_per_worker=16)
        drained = 0
        for i in range(40):
            k = rec.next_key()
            self.close_tree(rec, k, i * 0.1)
            if i % 7 == 0:
                drained += len(rec.drain())
        drained += len(rec.drain(force=True))
        s = rec.stats
        assert s["events"] == (drained + rec.n_events + s["dropped_cap"]
                               + s["dropped_sampled"])
        assert s["requests_sampled_out"] > 0

    def test_bare_recorder_unchanged(self):
        rec = TraceRecorder()
        self.close_tree(rec, rec.next_key(), 0.0)
        assert rec.stats["dropped_cap"] == 0
        assert rec.stats["dropped_sampled"] == 0
        assert validate_span_tree(rec.chrome_trace()) == []

    def test_counter_events_export_as_counter_tracks(self):
        rec = TraceRecorder()
        rec.counter("queue_depth", 0.0, 3)
        rec.counter("queue_depth", 0.1, 5)
        doc = rec.chrome_trace()
        assert validate_chrome_trace(doc) == []
        ctrs = [e for e in doc["traceEvents"] if e.get("ph") == "C"]
        assert len(ctrs) == 2
        assert ctrs[0]["args"] == {"value": 3.0}
        assert ctrs[0]["tid"] == 0


# ---------------------------------------------------------------------------
# Flusher: rotating segments, manifest, concat, replay byte-identity
# ---------------------------------------------------------------------------

class TestObsFlusher:
    def test_segment_boundaries_pure_function_of_virtual_time(self, tmp_path):
        rec = TraceRecorder()
        fl = ObsFlusher(str(tmp_path), recorder=rec, scrape_every_s=1.0)
        assert fl.maybe_flush(0.0) == 0      # first call arms
        assert fl.maybe_flush(0.5) == 0
        assert fl.maybe_flush(3.7) == 3      # catch-up: 1.0, 2.0, 3.0
        assert fl.maybe_flush(3.8) == 0
        assert fl.seq == 3

    def test_requires_recorder_or_registry(self, tmp_path):
        with pytest.raises(ValueError):
            ObsFlusher(str(tmp_path))
        with pytest.raises(ValueError):
            ObsFlusher(str(tmp_path), recorder=TraceRecorder(),
                       scrape_every_s=0.0)

    def test_streaming_run_segments_concat_to_valid_trace(self, tmp_path):
        out = str(tmp_path / "obs")
        rec, fl, sched, summary = run_streaming(out, rate=1.0)
        paths = segment_paths(out)
        assert len(paths) >= 2               # actually rotated mid-run
        for p in paths:                      # each segment valid standalone
            with open(p) as f:
                assert validate_chrome_trace(json.load(f)) == []
        doc = concat_dir(out)
        assert validate_chrome_trace(doc) == []
        assert validate_span_tree(doc) == []
        trees = request_trees(doc)
        assert sum(t["root"] is not None for t in trees.values()) \
            == summary["completed"] == 24
        assert doc["otherData"]["segments"] == len(paths)
        # Manifest bookkeeping matches the directory.
        with open(os.path.join(out, "manifest.json")) as f:
            man = json.load(f)
        assert man["trace_segments"] == [os.path.basename(p) for p in paths]
        assert man["sampler"] == {"rate": 1.0, "seed": 0, "head": 4}

    def test_replay_segments_byte_identical(self, tmp_path):
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        run_streaming(a, rate=0.25, tight_deadlines=range(16, 24))
        run_streaming(b, rate=0.25, tight_deadlines=range(16, 24))
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b))
        for n in names:
            with open(os.path.join(a, n), "rb") as f:
                blob_a = f.read()
            with open(os.path.join(b, n), "rb") as f:
                blob_b = f.read()
            assert blob_a == blob_b, f"segment {n} differs across replays"

    def test_anomalous_trees_survive_zero_sample_rate(self, tmp_path):
        out = str(tmp_path / "obs")
        rec, fl, sched, summary = run_streaming(
            out, rate=0.0, head=0, tight_deadlines=range(12, 24))
        assert summary["expired"] > 0
        doc = concat_dir(out)
        trees = request_trees(doc)
        statuses = [t["root"]["args"]["status"] for t in trees.values()
                    if t["root"] is not None]
        # Every expired request retained; every plain "done" sampled out.
        assert statuses.count("expired") == summary["expired"]
        assert "done" not in statuses
        assert rec.stats["requests_sampled_out"] > 0
        assert doc["otherData"]["drops"]["requests_sampled_out"] \
            == rec.stats["requests_sampled_out"]

    def test_cap_bounds_recorder_memory(self, tmp_path):
        out = str(tmp_path / "obs")
        rec, fl, sched, summary = run_streaming(out, n=48, rate=1.0, cap=64)
        assert rec.peak_buffered < 64 + 48       # cap + one tree's slack
        # Unbounded replay of the same trace buffers far more.
        rec2, *_ = run_streaming(str(tmp_path / "ub"), n=48, rate=1.0,
                                 scrape_every=1e9)
        assert rec2.peak_buffered > rec.peak_buffered
        if rec.stats["requests_shed"]:
            d = concat_dir(out)["otherData"]["drops"]
            assert d["requests_shed"] == rec.stats["requests_shed"]

    def test_counter_tracks_in_streamed_trace(self, tmp_path):
        out = str(tmp_path / "obs")
        run_streaming(out, rate=1.0)
        doc = concat_dir(out)
        ctr_names = {e["name"] for e in doc["traceEvents"]
                     if e.get("ph") == "C"}
        assert "queue_depth" in ctr_names
        assert "budget_lam" in ctr_names

    def test_gen_span_links_validate_and_catch_mismatch(self, tmp_path):
        out = str(tmp_path / "obs")
        run_streaming(out, rate=1.0)
        doc = concat_dir(out)
        legs = [e for e in doc["traceEvents"]
                if e.get("name") == "leg" and e.get("ph") == "X"]
        assert legs and all("gen" in e["args"] for e in legs)
        assert validate_span_tree(doc) == []
        # Tampered link: point one leg at a generate batch that is not its
        # own — the validator must notice.
        legs[0]["args"]["gen"] = 10 ** 9
        assert any("gen" in p for p in validate_span_tree(doc))


# ---------------------------------------------------------------------------
# SLO window math + burn-rate alerting
# ---------------------------------------------------------------------------

class TestRollingWindow:
    @given(st.lists(st.floats(0.0, 10.0), min_size=1, max_size=40))
    @settings(max_examples=60, deadline=None)
    def test_totals_match_naive_reference(self, times):
        """Bucketed totals agree with a brute-force scan up to bucket-edge
        granularity: every event inside (now - W, now] shifted by one
        bucket width is counted, nothing older than W + width survives."""
        w = RollingWindow(2.0, n_buckets=20)
        for i, t in enumerate(times):
            w.add(t, bad=i % 2, value=1.0)
        now = max(times)
        n, bad, val = w.totals(now)
        width = w.width
        lo_n = sum(1 for t in times if now - 2.0 + width < t <= now)
        hi_n = sum(1 for t in times if now - 2.0 - width < t <= now + width)
        assert lo_n <= n <= hi_n
        assert val == float(n)

    def test_out_of_order_adds_land_in_window(self):
        w = RollingWindow(10.0)
        w.add(9.0)
        w.add(3.0)     # late arrival from a lagging worker
        w.add(9.5)
        assert w.totals(10.0)[0] == 3
        assert w.totals(25.0)[0] == 0

    def test_pruning_keeps_memory_bounded(self):
        w = RollingWindow(1.0, n_buckets=10)
        for i in range(10000):
            w.add(i * 0.01)
        assert len(w._buckets) < 30

    def test_invalid_window_rejected(self):
        with pytest.raises(ValueError):
            RollingWindow(0.0)


class TestBurnRateSLO:
    def test_burn_is_bad_fraction_over_budget(self):
        s = BurnRateSLO("deadline_miss", error_budget=0.1, short_s=1.0,
                        long_s=12.0)
        for i in range(10):
            s.observe(float(i), bad=(i < 2))   # 20% bad overall
        b = s.burns(10.0)
        assert b["long"] == pytest.approx((2 / 10) / 0.1)

    def test_multi_window_gating_resists_blips(self):
        """A short bad blip after a long good stretch must not fire; a
        sustained burn must."""
        s = BurnRateSLO("deadline_miss", error_budget=0.05, short_s=1.0,
                        long_s=12.0, threshold=1.0)
        for i in range(110):
            s.observe(i * 0.1, bad=False)      # 11s of clean traffic
        for i in range(3):
            s.observe(11.0 + i * 0.1, bad=True)
        assert s.burns(11.3)["short"] >= 1.0   # blip spikes the short win
        assert not s.evaluate(11.3)            # ...but long window holds
        for i in range(60):
            s.observe(11.3 + i * 0.1, bad=True)
        assert s.evaluate(17.3)                # sustained: both windows over

    def test_min_events_guard(self):
        s = BurnRateSLO("x", error_budget=0.01, short_s=1.0, long_s=2.0,
                        min_events=5)
        s.observe(0.0, bad=True)
        assert s.burns(0.5) == {"short": 0.0, "long": 0.0}

    @given(st.floats(0.05, 1.0), st.integers(1, 30))
    @settings(max_examples=40, deadline=None)
    def test_all_bad_burn_is_budget_inverse(self, budget, n):
        s = BurnRateSLO("x", error_budget=budget, short_s=1.0, long_s=4.0)
        for i in range(n):
            s.observe(i * 4.0 / max(n, 1) * 0.9, bad=True)
        assert s.burns(3.6)["long"] == pytest.approx(1.0 / budget)

    def test_spend_burn_tracks_rate_vs_budget(self):
        s = SpendBurnSLO("spend", budget=100.0, window_s=10.0, short_s=1.0)
        # Spend 200 over the 10s window: 2x the budgeted rate.
        for i in range(10):
            s.observe(i * 1.0 + 0.5, cost=20.0)
        assert s.burns(10.0)["long"] == pytest.approx(2.0)
        assert s.evaluate(10.0)


class TestSLOTracker:
    def test_alert_transitions_and_trace_instants(self):
        rec = TraceRecorder()
        s = BurnRateSLO("deadline_miss", error_budget=0.05, short_s=0.5,
                        long_s=6.0)
        tr = SLOTracker([s], tracer=rec, check_every_s=0.25)
        for i in range(40):
            tr.observe_request(i * 0.1, e2e_s=0.01, missed=True,
                               quality=1.0, cost=0.0)
        assert tr.check(4.0, force=True)
        assert tr.firing() == ["deadline_miss"]
        # Recovery: a long clean stretch clears both windows.
        for i in range(400):
            tr.observe_request(4.0 + i * 0.05, e2e_s=0.01, missed=False,
                               quality=1.0, cost=0.0)
        assert tr.check(24.0, force=True)
        assert tr.firing() == []
        states = [a["state"] for a in tr.alerts]
        assert states == ["firing", "resolved"]
        names = [e[0] for e in rec.events]
        assert names.count("slo_alert") == 2

    def test_check_is_throttled(self):
        s = BurnRateSLO("x", error_budget=0.5, short_s=1.0, long_s=2.0)
        tr = SLOTracker([s], check_every_s=1.0)
        tr.check(0.0)
        nxt = tr._next_check
        tr.check(0.5)
        assert tr._next_check == nxt

    def test_build_slo_tracker(self):
        assert build_slo_tracker() is None
        tr = build_slo_tracker(p95_target_s=0.01, miss_rate_budget=0.02,
                               quality_floor=0.5, spend_per_window=10.0,
                               window_s=0.24)
        assert [s.name for s in tr.slos] == [
            "latency_p95", "deadline_miss", "quality_floor", "spend"]
        assert tr.slos[0].short.window_s == pytest.approx(0.02)
        assert tr.check_every_s == pytest.approx(0.01)

    def test_scheduler_integration_fires_deadline_slo(self, tmp_path):
        slo = build_slo_tracker(miss_rate_budget=0.01, window_s=0.12,
                                threshold=1.0)
        rec, fl, sched, summary = run_streaming(
            str(tmp_path / "obs"), rate=1.0,
            tight_deadlines=range(8, 24), slo=slo)
        assert summary["expired"] > 0
        assert any(a["slo"] == "deadline_miss" and a["state"] == "firing"
                   for a in slo.alerts)
        doc = concat_dir(str(tmp_path / "obs"))
        assert any(e["name"] == "slo_alert" for e in doc["traceEvents"]
                   if e.get("ph") == "i")

    def test_slo_replay_determinism(self, tmp_path):
        def run(sub):
            slo = build_slo_tracker(miss_rate_budget=0.01, window_s=0.12)
            run_streaming(str(tmp_path / sub), rate=1.0,
                          tight_deadlines=range(8, 24), slo=slo)
            return slo.alerts
        assert run("a") == run("b")


# ---------------------------------------------------------------------------
# BoundedSeries (deterministically downsampled telemetry series)
# ---------------------------------------------------------------------------

class TestBoundedSeries:
    def test_memory_bounded_coverage_whole_run(self):
        s = BoundedSeries(cap=64)
        for i in range(10000):
            s.append(i * 0.001, float(i))
        assert len(s) < 64
        assert s.n_seen == 10000
        # Whole-run coverage: the head survives decimation (a ring buffer
        # would have discarded it) and the kept tail is recent.
        assert s[0][0] == 0.0
        assert s[-1][0] > 9.0
        # Uniform resolution: consecutive kept points are one stride apart.
        ts = [t for t, _ in s]
        gaps = {round(b - a, 9) for a, b in zip(ts, ts[1:])}
        assert len(gaps) == 1

    def test_deterministic_replay(self):
        def build():
            s = BoundedSeries(cap=32)
            for i in range(777):
                s.append(i * 0.01, i % 17)
            return list(s)
        assert build() == build()

    @given(st.integers(1, 2000))
    @settings(max_examples=40, deadline=None)
    def test_len_never_exceeds_cap(self, n):
        s = BoundedSeries(cap=16)
        for i in range(n):
            s.append(float(i), 0.0)
        assert len(s) <= 16
        assert bool(s) is (n > 0)

    def test_merge_spans_both_runs_and_stays_bounded(self):
        a, b = BoundedSeries(cap=32), BoundedSeries(cap=32)
        for i in range(500):
            a.append(i * 0.01, 1.0)           # t in [0, 5)
            b.append(5.0 + i * 0.01, 2.0)     # t in [5, 10)
        a.merge(b)
        assert len(a) < 32
        assert a.n_seen == 1000
        ts = [t for t, _ in a]
        assert ts == sorted(ts)
        assert ts[0] < 1.0 and ts[-1] > 9.0   # coverage spans both workers

    def test_small_series_kept_exactly(self):
        s = BoundedSeries(cap=4096)
        for i in range(10):
            s.append(float(i), float(-i))
        assert list(s) == [(float(i), float(-i)) for i in range(10)]
        assert s.stride == 1

    def test_telemetry_uses_bounded_series(self):
        te = Telemetry(["m0"])
        for i in range(10000):
            te.record_lambda(i * 1e-3, 50.0)
            te.record_queue_depth(i * 1e-3, i % 7)
        assert isinstance(te.lam_trace, BoundedSeries)
        assert len(te.lam_trace) <= 4096
        assert len(te.depth_trace) <= 4096
        other = Telemetry(["m0"])
        other.record_lambda(99.0, 10.0)
        te.merge(other)
        assert te.lam_trace.n_seen == 10001


# ---------------------------------------------------------------------------
# Both packages, byte for byte
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from repro import obs as ref_obs  # noqa: E402
from repro.serving import MicroBatchScheduler as JaxScheduler  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro_torch import obs as port_obs  # noqa: E402

PORT = SimpleNamespace(obs=port_obs, Request=Request, MicroBatchScheduler=MicroBatchScheduler,
                       SchedulerConfig=SchedulerConfig)
REF = SimpleNamespace(obs=ref_obs, Request=JaxRequest, MicroBatchScheduler=JaxScheduler,
                      SchedulerConfig=JaxSchedulerConfig)


def _files(out_dir):
    return {n: open(os.path.join(out_dir, n), "rb").read()
            for n in sorted(os.listdir(out_dir))}


def _event_program(seed, n=400):
    """A seeded mix of recorder and registry operations, host floats only:
    instants, spans (request roots close trees; expire/readmit mark the
    anomaly lane), counters, metric updates, and flush points."""
    rng = np.random.default_rng(seed)
    prog, t, open_keys, next_key = [], 0.0, [], 0
    names = ["admit", "queue_wait", "leg", "generate", "score_batch", "readmit", "expire"]
    for _ in range(n):
        t += float(rng.exponential(1e-3))
        wid = int(rng.integers(0, 3))
        u = rng.random()
        if u < 0.15 or not open_keys:
            prog.append(("key", next_key, wid, t))
            open_keys.append(next_key)
            next_key += 1
        elif u < 0.45:
            key = open_keys[int(rng.integers(len(open_keys)))]
            prog.append(("instant", str(rng.choice(names)), wid, t, key,
                         {"depth": int(rng.integers(0, 9)), "x": float(rng.normal())}))
        elif u < 0.6:
            key = open_keys.pop(int(rng.integers(len(open_keys))))
            prog.append(("span", "request", wid, t - float(rng.uniform(0, 5e-3)), t, key,
                         {"status": str(rng.choice(["done", "expired"])), "legs": 1,
                          "cum_cost": float(rng.uniform(0, 1e-3))}))
        elif u < 0.7:
            prog.append(("span", "score_batch", wid, t, t + 2e-4, None,
                         {"n": int(rng.integers(1, 64))}))
        elif u < 0.75:
            prog.append(("counter", "queue_depth", wid, t, float(rng.integers(0, 30))))
        elif u < 0.8:
            prog.append(("wall", t))
        elif u < 0.95:
            prog.append(("metric", str(rng.choice(["c", "g", "h", "m"])), wid,
                         float(rng.lognormal(-4, 2))))
        else:
            prog.append(("flush", t))
    return prog, t


def _replay_program(pkg, prog, t_end, out_dir, *, sampler, cap):
    o = pkg.obs
    rec = o.TraceRecorder(label="parity", max_buffered_per_worker=cap,
                          sampler=None if sampler is None else o.TraceSampler(
                              sampler[0], seed=sampler[1], head=sampler[2]))
    reg = o.MetricsRegistry()
    views = [rec.scoped(w) for w in range(3)]
    counters = [reg.counter("ops_total", "ops", labels=(("worker", str(w)),)) for w in range(3)]
    gauge = reg.gauge("level", "last value")
    hist = reg.histogram("lat_s", "latency")
    state = {}
    reg.multi_gauge("by_worker", "per-worker last value", "worker",
                    fn=lambda: dict(state))
    reg.gauge("wall_level", "wall-clock gauge", wall=True, fn=lambda: 0.5)
    flusher = (None if out_dir is None else
               o.ObsFlusher(out_dir, recorder=rec, registry=reg, scrape_every_s=5e-3,
                            label="parity"))
    for op in prog:
        kind = op[0]
        if kind == "key":
            assert rec.next_key() == op[1]
            views[op[2]].instant("admit", "queue", op[3], key=op[1])
        elif kind == "instant":
            views[op[2]].instant(op[1], "request", op[3], key=op[4], args=op[5])
        elif kind == "span":
            views[op[2]].span(op[1], "request" if op[5] is not None else "sched",
                              op[3], op[4], key=op[5], args=op[6])
        elif kind == "counter":
            views[op[2]].counter(op[1], op[3], op[4])
        elif kind == "wall":
            rec.span("kernel:pairwise_l2", "kernel", op[1], op[1] + 1e-5, args={"us": 10.0})
        elif kind == "metric":
            _, m, wid, v = op
            if m == "c":
                counters[wid].inc(v)
            elif m == "g":
                gauge.set(v)
            elif m == "h":
                hist.observe(v)
            else:
                state[str(wid)] = v
        elif kind == "flush" and flusher is not None:
            flusher.maybe_flush(op[1])
    if flusher is not None:
        flusher.finalize(t_end)
    return rec, reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_events_give_the_references_bytes(seed, tmp_path):
    prog, t_end = _event_program(seed)
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        rec, reg = _replay_program(pkg, prog, t_end, None, sampler=None, cap=None)
        out[name] = (rec.to_json(), rec.to_json(include_wall=True),
                     reg.to_json(deterministic=True), reg.to_json(),
                     reg.prometheus(deterministic=True), reg.prometheus())
    assert out["port"] == out["ref"]
    assert json.loads(out["port"][0])["traceEvents"]


@pytest.mark.parametrize("seed,sampler,cap", [(3, (0.3, 7, 4), None), (4, (0.5, 0, 0), 16),
                                              (5, None, 25)])
def test_seeded_streams_give_the_references_segment_files(seed, sampler, cap, tmp_path):
    prog, t_end = _event_program(seed)
    files = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        d = str(tmp_path / name)
        rec, _ = _replay_program(pkg, prog, t_end, d, sampler=sampler, cap=cap)
        files[name] = (_files(d), rec.drop_stats, rec.peak_buffered)
    assert files["port"] == files["ref"]
    assert len(files["port"][0]) > 6
    stats = files["port"][1]
    assert (stats["requests_sampled_out"] > 0) == (sampler is not None)
    assert (stats["requests_shed"] > 0) == (cap is not None)
    doc = port_obs.concat_dir(str(tmp_path / "port"))
    assert doc == ref_obs.concat_dir(str(tmp_path / "ref"))
    assert validate_chrome_trace(doc) == []


def _fake_engine_run(pkg, out_dir=None, n=24):
    """The traced fake-engine scheduler run with ``pkg``'s classes: a
    recorder (streaming with a sampler and flusher when ``out_dir``), the
    scheduler's metrics, and an SLO tracker with tight deadlines."""
    o = pkg.obs
    if out_dir is None:
        rec, flusher = o.TraceRecorder(label="fake"), None
    else:
        rec = o.TraceRecorder(label="fake", sampler=o.TraceSampler(0.25, seed=0, head=4),
                              max_buffered_per_worker=64)
        flusher = o.ObsFlusher(out_dir, recorder=rec, scrape_every_s=0.002, label="fake")
    reg = o.MetricsRegistry()
    slo = o.build_slo_tracker(tracer=rec, miss_rate_budget=0.01, p95_target_s=0.004,
                              window_s=0.12)
    sched = pkg.MicroBatchScheduler(
        FakeEngine(), pkg.SchedulerConfig(score_batch=8, max_batch=4, queue_capacity=12),
        service_time=lambda kind, n_, wall: 1e-3, tracer=rec.scoped(0), slo=slo,
        flusher=flusher)
    o.register_scheduler_metrics(reg, sched)
    o.register_slo_metrics(reg, slo, lambda: sched.clock.now)
    if flusher is not None:
        o.register_stream_metrics(reg, flusher)
    reqs = [pkg.Request(text=str(i), prompt=np.zeros(4, np.int32), max_new=2,
                        arrival_s=i * 1e-4, deadline_s=0.002 if i >= 16 else None)
            for i in range(n)]
    summary = sched.run_trace(reqs)
    slo.check(sched.clock.now, force=True)
    if flusher is not None:
        flusher.finalize(sched.clock.now)
        trace = o.trace.trace_doc_to_json(o.concat_dir(out_dir))
    else:
        trace = rec.to_json()
    return {"trace": trace, "metrics": reg.to_json(deterministic=True),
            "prom": reg.prometheus(deterministic=True), "alerts": slo.alerts,
            "summary": {k: v for k, v in summary.items() if not k.startswith("routing_")}}


@pytest.mark.parametrize("streaming", [False, True], ids=["recorder", "streaming"])
def test_traced_fake_scheduler_gives_the_references_bytes(streaming, tmp_path):
    out = {name: _fake_engine_run(pkg, str(tmp_path / name) if streaming else None)
           for name, pkg in (("ref", REF), ("port", PORT))}
    assert out["port"] == out["ref"]
    assert out["port"]["summary"]["expired"] > 0 and out["port"]["alerts"]
    if streaming:
        assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "ref"))
    doc = json.loads(out["port"]["trace"])
    assert validate_chrome_trace(doc) == [] and validate_span_tree(doc) == []


# tools/obs_smoke.py's streaming cascade scenario: the cascade smoke's world,
# an attn-ens router trained by the reference and carried across by npz.

from repro import cascade as jax_cascade  # noqa: E402
from repro import checkpoint as jax_ckpt  # noqa: E402
from repro.serving import RoutedEngine as JaxEngine  # noqa: E402
from repro_torch import cascade as port_cascade  # noqa: E402
from repro_torch.checkpoint import load_router  # noqa: E402
from repro_torch.serving.engine import RoutedEngine  # noqa: E402
from test_torch_cascade import (  # noqa: E402
    COST, LAM, N_REQ, QUAL_EASY, QUAL_HARD, JaxStub, PortStub, _jax_router, _region, _world,
)

OBS_SMOKE = dict(rate=0.25, cap=4096, scrape_s=2e-3)


def _obs_smoke_run(pkg, cascade_mod, engine, out_dir):
    """``tools/obs_smoke.py::run_traced`` in streaming mode, on ``pkg``'s
    classes and ``engine``: returns the concatenated trace, the metrics
    JSON and Prometheus text, the segment files and the summary."""
    o = pkg.obs
    rng = np.random.default_rng(0)
    _world(rng)
    easy, hard = _region(rng, N_REQ // 2, +1.0), _region(rng, N_REQ // 2, -1.0)
    ladder = cascade_mod.cost_ladder(engine.router)
    truth, reqs, embs = {}, [], []
    for i in range(N_REQ):
        is_hard = i % 2 == 1
        text = f"{'hard' if is_hard else 'easy'}-{i}"
        truth[text] = QUAL_HARD if is_hard else QUAL_EASY
        r = pkg.Request(text=text, prompt=np.zeros(2, np.int32), max_new=2,
                        arrival_s=i * 1e-3)
        r.forced_member = int(ladder[0])
        r.forced_member_name = engine.pool[int(ladder[0])].name
        reqs.append(r)
        embs.append(hard[i // 2] if is_hard else easy[i // 2])
    emb_of = {r.text: e for r, e in zip(reqs, embs)}
    engine.embed = lambda texts: np.stack([emb_of[t] for t in texts])
    label = "obs-smoke-seed0"
    rec = o.TraceRecorder(label=label, sampler=o.TraceSampler(OBS_SMOKE["rate"], seed=0,
                                                              head=0),
                          max_buffered_per_worker=OBS_SMOKE["cap"])
    flusher = o.ObsFlusher(out_dir, recorder=rec, scrape_every_s=OBS_SMOKE["scrape_s"],
                           label=label)
    reg = o.MetricsRegistry()
    coord = cascade_mod.CascadeCoordinator(
        cascade_mod.CascadePolicy(ladder, cascade_mod.CascadeConfig(max_legs=3, beta=1.0)),
        observed_quality=lambda r: float(truth[r.text][r.member]))
    sched = pkg.MicroBatchScheduler(
        engine, pkg.SchedulerConfig(score_batch=16, max_batch=16), cascade=coord,
        service_time=lambda kind, n, wall: 1e-3, tracer=rec.scoped(0), flusher=flusher)
    o.register_scheduler_metrics(reg, sched)
    summary = sched.run_trace(reqs)
    flusher.finalize(sched.clock.now)
    return {"trace": o.trace.trace_doc_to_json(o.concat_dir(out_dir)),
            "metrics": reg.to_json(deterministic=True),
            "prom": reg.prometheus(deterministic=True), "files": _files(out_dir),
            "summary": {k: v for k, v in summary.items() if not k.startswith("routing_")}}


def _split_floats(trace_json, fields):
    """(the trace's bytes with ``fields`` of every event's args blanked,
    those fields' values in event order)."""
    doc = json.loads(trace_json)
    vals = []
    for e in doc["traceEvents"]:
        for f in fields:
            if f in e.get("args", {}):
                vals.append(e["args"][f])
                e["args"][f] = None
    return port_obs.trace.trace_doc_to_json(doc), np.asarray(vals, np.float64)


def _same_trace(got, want, fields=(), tol=0.0):
    """Byte-equal traces, except ``fields``, which derive from the router's
    float32 scores (XLA and torch sum them in different orders): those must
    agree within ``tol`` relative to max(1, |value|)."""
    g, gv = _split_floats(got, fields)
    w, wv = _split_floats(want, fields)
    assert g == w
    assert gv.shape == wv.shape
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol * max(1.0, float(np.abs(wv).max(
        initial=0.0))))
    return len(gv)


def test_obs_smoke_streaming_cascade_gives_the_references_bytes(tmp_path):
    """Everything but the cascade decisions' ``expected_gain`` byte for byte;
    that gain is a difference of R2 rewards of the attn-ens router's float32
    scores, within 1e-6 of the reference's, as the cascade tests hold it
    (``test_torch_cascade.py``). The port replays its own bytes exactly."""
    jr = _jax_router(*_world(np.random.default_rng(0)))
    path = str(tmp_path / "ens.npz")
    jax_ckpt.save_router(path, jr)
    names = ("cheap", "mid", "strong")
    ref = _obs_smoke_run(REF, jax_cascade, JaxEngine(
        router=jr, pool=[JaxStub(n, c) for n, c in zip(names, COST)], lam=LAM),
        str(tmp_path / "ref"))
    port = [_obs_smoke_run(PORT, port_cascade, RoutedEngine(
        router=load_router(path, device="cpu"),
        pool=[PortStub(n, c) for n, c in zip(names, COST)], lam=LAM, device="cpu"),
        str(tmp_path / f"port{i}")) for i in range(2)]
    assert port[0] == port[1]
    for key in ("metrics", "prom", "summary"):
        assert port[0][key] == ref[key], key
    n = _same_trace(port[0]["trace"], ref["trace"], ("expected_gain",), 1e-6)
    assert n > 0
    assert port[0]["files"].keys() == ref["files"].keys()
    for name, blob in ref["files"].items():
        if name.startswith("trace-"):
            _same_trace(port[0]["files"][name].decode(), blob.decode(),
                        ("expected_gain",), 1e-6)
        else:
            assert port[0]["files"][name] == blob, name
    s = port[0]["summary"]
    assert s["completed"] == N_REQ and s["escalations"] > 0
    doc = json.loads(port[0]["trace"])
    assert validate_chrome_trace(doc) == [] and validate_span_tree(doc) == []
    assert any(len(t["legs"]) > 1 for t in request_trees(doc).values())


# The smoke pool with the semantic cache (``test_torch_trace.py``'s set-up),
# traced in both packages.

from repro.checkpoint import save_router as jax_save_router  # noqa: E402
from repro.core.clustering import kmeans as jax_kmeans  # noqa: E402
from repro.launch.serve import build_pool as jax_build_pool  # noqa: E402
from repro.online.drift import DriftDetector as JaxDetector  # noqa: E402
from repro.serving.scheduler import default_service_model as jax_service_model  # noqa: E402
from repro.serving.semcache import SemanticCache as JaxCache  # noqa: E402
from repro.serving.traffic import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.serving.traffic import make_trace as jax_make_trace  # noqa: E402
from repro_torch.data.routerbench import generate  # noqa: E402
from repro_torch.launch.serve import build_scheduler  # noqa: E402
from repro_torch.online.drift import DriftDetector  # noqa: E402
from repro_torch.serving.semcache import SemanticCache, calibrate_radius  # noqa: E402
from repro_torch.serving.traffic import TraceConfig, make_trace  # noqa: E402
from test_torch_serving import NAMES, _port_pool  # noqa: E402
from test_torch_serving import _jax_router as _serving_router  # noqa: E402
from test_torch_trace import DRIFT, FLOOR, TRACE  # noqa: E402

POOL_TRACE = dict(TRACE, n_requests=16)
# Router-derived floats in the trace: a cache entry's quality is the
# router's float32 score of its member; a cached answer's distance is a
# float32 pairwise_l2 (the reference's Pallas kernel, the port's plain
# version: different summation orders).
POOL_FLOATS = ("q", "dist")


def test_smoke_pool_with_the_cache_traces_the_references_bytes(tmp_path):
    data = generate(240, seed=0)
    tr, _, te = data.split(seed=0)
    train, held = data.emb[tr], [data.texts[i] for i in te]
    centroids, _ = jax_kmeans(train, 20, seed=0)
    radius = calibrate_radius(train, device="cpu")
    router = dataclasses.replace(_serving_router(held[:16]), centroids=centroids)
    jax_engine = JaxEngine(router=router, pool=jax_build_pool(NAMES, seed=0), lam=1.0,
                           use_pallas=True)
    path = str(tmp_path / "router.npz")
    jax_save_router(path, router, pool_names=NAMES)
    port_router = load_router(path, expect_pool_names=NAMES, device="cpu")
    port_engine = RoutedEngine(router=port_router, pool=_port_pool(jax_engine.pool),
                               lam=1.0, device="cpu")
    vocab = min(m.cfg.vocab_size for m in jax_engine.pool)

    ref_rec = ref_obs.TraceRecorder(label="pool")
    ref_cache = JaxCache(radius, quality_floor=FLOOR,
                         drift=JaxDetector(**DRIFT).fit(train, centroids))
    ref_sched = JaxScheduler(jax_engine, JaxSchedulerConfig(score_batch=8, max_batch=8),
                             semcache=ref_cache, service_time=jax_service_model(),
                             tracer=ref_rec.scoped(0))
    ref_summary = ref_sched.run_trace(jax_make_trace(JaxTraceConfig(vocab=vocab,
                                                                    **POOL_TRACE), held))

    rec = port_obs.TraceRecorder(label="pool")
    cache = SemanticCache(radius, quality_floor=FLOOR, device="cpu", drift=DriftDetector(
        device="cpu", **DRIFT).fit(train, port_router.centroids))
    sched = build_scheduler(port_engine, score_batch=8, max_batch=8, max_wait_s=0.02,
                            queue_capacity=256, semcache=cache, tracer=rec.scoped(0),
                            device="cpu")
    summary = sched.run_trace(make_trace(TraceConfig(vocab=vocab, **POOL_TRACE), held))

    assert summary["completed"] == ref_summary["completed"] == 16
    assert cache.stats["served"] > 0
    n = _same_trace(rec.to_json(), ref_rec.to_json(), POOL_FLOATS, 1e-5)
    assert n > 0
    doc = rec.chrome_trace()
    assert validate_chrome_trace(doc) == [] and validate_span_tree(doc) == []


# The profiler on the port's own dispatch path, and the serve entry point.

from repro_torch.checkpoint import save_router  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


def _stub_engine():
    return RoutedEngine(router=serve.init_router(3, seed=4, device="cpu"),
                        pool=[PortStub(n, c) for n, c in zip(("a", "b", "c"), COST)],
                        lam=LAM, device="cpu")


def _stub_run(make_profiler):
    """A traced run through the port's engine (scores by
    ``ops.router_xattn_pool``) with ``make_profiler(recorder)`` installed
    (None: no profiler), removed after; returns (recorder, profiler,
    summary)."""
    rng = np.random.default_rng(3)
    engine = _stub_engine()
    emb = rng.standard_normal((32, 768)).astype(np.float32)
    engine.embed = lambda texts: emb[[int(t) for t in texts]]
    rec = port_obs.TraceRecorder(label="stub")
    sched = MicroBatchScheduler(engine, SchedulerConfig(score_batch=8, max_batch=8),
                                service_time=lambda kind, n, wall: 1e-3,
                                tracer=rec.scoped(0))
    reqs = [req(text=str(i), arrival=i * 2e-4) for i in range(32)]
    profiler = None if make_profiler is None else make_profiler(rec)
    kops.set_kernel_profiler(profiler)
    try:
        summary = sched.run_trace(reqs)
    finally:
        kops.set_kernel_profiler(None)
    return rec, profiler, summary


def test_profiler_counts_cpu_dispatches_and_stays_out_of_the_deterministic_trace():
    """With the profiler installed and tracing into the run's own recorder,
    as ``--trace-profile`` wires it, each scoring pass is one profiled
    ``router_xattn_pool`` call with its rows and one ``kernel`` span; the
    deterministic trace is the unprofiled run's, byte for byte."""
    rec_off, _, summary = _stub_run(None)
    rec_on, prof, _ = _stub_run(lambda rec: KernelProfiler(tracer=rec))
    assert kops.get_kernel_profiler() is None
    calls = prof.summary()
    assert set(calls) == {"router_xattn_pool"}
    assert calls["router_xattn_pool"]["calls"] == summary["score_batches"] >= 4
    assert calls["router_xattn_pool"]["elements"] == 32
    assert rec_on.to_json() == rec_off.to_json()
    wall = [e for e in rec_on.chrome_trace(include_wall=True)["traceEvents"]
            if e.get("cat") == "kernel"]
    assert len(wall) == calls["router_xattn_pool"]["calls"]
    assert all(e["args"]["batch"] > 0 and e["args"]["us"] > 0 for e in wall)


@pytest.fixture(scope="module")
def router_path(tmp_path_factory):
    """A seeded router checkpoint for the default pool (no centroids: the
    serve entry point fits them), so the serve drives skip training."""
    path = str(tmp_path_factory.mktemp("router") / "router.npz")
    save_router(path, serve.init_router(3, seed=0, device="cpu"),
                pool_names=serve.DEFAULT_POOL.split(","))
    return path


SERVE_FLAGS = ["--smoke", "--device", "cpu", "--trace", "neardup", "--semcache",
               "--requests", "24", "--max-new", "2", "--budget", "0.001",
               "--slo-p95", "0.03", "--slo-miss-rate", "0.05"]


def _serve(router_path, *flags):
    import contextlib
    import io

    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        serve.main([*SERVE_FLAGS, "--router", router_path, *flags])
    assert kops.get_kernel_profiler() is None
    return stdout.getvalue().splitlines()


def _serve_streaming(router_path, out_dir):
    os.makedirs(out_dir)
    paths = {n: os.path.join(out_dir, n) for n in ("t.json", "m.json", "m.prom")}
    lines = _serve(router_path, "--trace-out", paths["t.json"], "--metrics-out",
                   paths["m.json"], "--obs-dir", os.path.join(out_dir, "obs"),
                   "--trace-sample", "0.5", "--trace-head", "4", "--scrape-every", "0.02",
                   "--metrics-port", "0")
    return lines, _files(os.path.join(out_dir, "obs")), {
        n: open(p, "rb").read() for n, p in paths.items() if os.path.exists(p)}


def test_serve_obs_flags_replay_byte_identically(router_path, tmp_path):
    """Two runs of the serve entry point with the streaming obs flags give
    the same segment files, concatenated trace and metrics snapshot; the
    metrics endpoint is served on an ephemeral port and stopped."""
    lines, seg_a, out_a = _serve_streaming(router_path, str(tmp_path / "a"))
    _, seg_b, out_b = _serve_streaming(router_path, str(tmp_path / "b"))
    assert seg_a == seg_b and out_a == out_b
    assert "manifest.json" in seg_a and len(seg_a) > 4
    assert any(x.startswith("metrics endpoint: http://127.0.0.1:") for x in lines)
    assert any(x.startswith("obs segments written to ") for x in lines)
    assert any(x.startswith("slo: ") for x in lines)
    doc = json.loads(out_a["t.json"])
    assert validate_chrome_trace(doc) == [] and validate_span_tree(doc) == []
    assert 4 <= trace_summary(doc)["requests"] < 24
    assert json.loads(out_a["m.json"])["requests_completed_total"]["value"] == 24


def test_serve_trace_profile_times_both_kernels(router_path, tmp_path):
    """``--trace-profile`` reports each kernel's dispatches, writes their
    wall-clock spans into the trace (category ``kernel``, one per call),
    and is removed when the run ends; the Prometheus text carries the
    kernel series."""
    trace_out, prom_out = str(tmp_path / "t.json"), str(tmp_path / "m.prom")
    lines = _serve(router_path, "--trace-out", trace_out, "--metrics-out", prom_out,
                   "--trace-profile")
    head = lines.index("kernel profile:")
    calls = {x.split()[0]: int(x.split()[2]) for x in lines[head + 1:head + 3]}
    assert sorted(calls) == ["pairwise_l2", "router_xattn_pool"]
    with open(trace_out) as f:
        doc = json.load(f)
    assert validate_chrome_trace(doc) == [] and validate_span_tree(doc) == []
    kernel = [e for e in doc["traceEvents"] if e.get("cat") == "kernel"]
    assert len(kernel) == sum(calls.values())
    assert doc["otherData"]["deterministic"] is False
    with open(prom_out) as f:
        text = f.read()
    assert 'kernel_calls_total{op="router_xattn_pool"}' in text
