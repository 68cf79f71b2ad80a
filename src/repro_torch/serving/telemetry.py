"""Serving telemetry: counters, latency histograms, spend, queue depth.

The port's own copy of ``repro.serving.telemetry``, with one deliberate
difference: :meth:`Histogram.percentile` returns exactly ``min`` at p = 0
and exactly ``max`` at p = 100. The reference's log interpolation can land
one ulp short of ``max`` at p = 100.

Everything the acceptance report needs — per-member routed counts and spend,
p50/p99 routing + end-to-end latency, queue-depth snapshots — collected with
plain counters and fixed log-spaced histogram buckets (no per-request lists,
so memory stays O(buckets) at any traffic volume).
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def exemplar_score(trace_key: int) -> int:
    """Deterministic min-hash rank of a trace key.

    The bucket exemplar kept is the key with the SMALLEST score — a pure
    function of the key itself, so which exemplar survives is independent
    of arrival order and of how per-worker histograms are merged, and a
    seeded replay reproduces the exact same exemplars.
    """
    digest = hashlib.blake2b(str(int(trace_key)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big")


class BoundedSeries:
    """Bounded (t, value) series with deterministic stride decimation.

    Keeps every ``stride``-th appended sample; when the kept set reaches
    ``cap`` points, every other point is dropped and the stride doubles.
    Unlike a ring buffer (the old ``deque(maxlen=...)``), coverage always
    spans the *whole* run — the head is thinned, never discarded — at
    resolution uniform in append index. The kept set is a pure function of
    the append sequence: replay-deterministic, no RNG, no wall clock.
    Memory is O(cap) at any traffic volume.
    """

    def __init__(self, cap: int = 4096):
        if cap < 2:
            raise ValueError("cap must be >= 2")
        self.cap = int(cap)
        self.stride = 1
        self.n_seen = 0
        self._points: List[Tuple[float, float]] = []

    def append(self, t: float, value: float) -> None:
        if self.n_seen % self.stride == 0:
            self._points.append((t, value))
            if len(self._points) >= self.cap:
                self._points = self._points[::2]
                self.stride *= 2
        self.n_seen += 1

    def merge(self, other: "BoundedSeries") -> None:
        """Fold another series in: union sorted by time, re-decimated to
        this series' cap (multi-worker rollup keeps whole-run coverage)."""
        pts = sorted(self._points + list(other._points))
        stride = max(self.stride, other.stride)
        while len(pts) >= self.cap:
            pts = pts[::2]
            stride *= 2
        self._points = pts
        self.stride = stride
        self.n_seen += other.n_seen

    def __len__(self) -> int:
        return len(self._points)

    def __iter__(self):
        return iter(self._points)

    def __getitem__(self, i):
        return self._points[i]

    def __bool__(self) -> bool:
        return bool(self._points)


class Histogram:
    """Log-bucketed latency histogram with interpolated percentiles."""

    def __init__(self, lo: float = 1e-6, hi: float = 1e3, n_buckets: int = 90):
        self.edges = np.logspace(math.log10(lo), math.log10(hi), n_buckets + 1)
        self.counts = np.zeros(n_buckets + 2, np.int64)  # +under/overflow
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        # Prometheus-style exemplars: raw bucket index -> (min-hash score,
        # trace_key, observed value). One per bucket, O(buckets) memory.
        self.exemplars: Dict[int, Tuple[int, int, float]] = {}

    def record(self, value: float, *, exemplar: Optional[int] = None) -> None:
        idx = int(np.searchsorted(self.edges, value, side="right"))
        self.counts[idx] += 1
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if exemplar is not None:
            # Lexicographic min over (score, key, value): the score picks
            # the surviving key, the full tuple breaks same-key ties so
            # the table is a pure function of the recorded set.
            cand = (exemplar_score(exemplar), int(exemplar), float(value))
            cur = self.exemplars.get(idx)
            if cur is None or cand < cur:
                self.exemplars[idx] = cand

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram in (identical bucket edges required)."""
        if not np.array_equal(self.edges, other.edges):
            raise ValueError("cannot merge histograms with different edges")
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for idx, ex in other.exemplars.items():
            cur = self.exemplars.get(idx)
            if cur is None or tuple(ex) < cur:
                self.exemplars[idx] = tuple(ex)

    def percentile(self, p: float) -> float:
        """Approximate percentile (log-interpolated inside the bucket).

        The under/overflow buckets have no fixed outer edge, so they
        interpolate against the observed min/max instead of collapsing to
        a single point — a histogram whose every value landed below
        ``edges[0]`` still reports percentile(100) == max, not min.
        Interpolation falls back to linear when a bucket bound is
        non-positive (only reachable through min/max in the under/overflow
        buckets; the interior edges are strictly positive).
        """
        if self.count == 0:
            return float("nan")
        # The ends are the observed extremes, exactly: interpolation in
        # log space can round one ulp inside them.
        if p <= 0.0:
            return self.min
        if p >= 100.0:
            return self.max
        target = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c > 0:
                frac = (target - seen) / c
                if i == 0:
                    lo, hi = self.min, min(self.edges[0], self.max)
                elif i >= len(self.edges):
                    lo, hi = max(self.edges[-1], self.min), self.max
                else:
                    lo, hi = self.edges[i - 1], self.edges[i]
                if lo > 0 and hi > 0:
                    est = lo * (hi / lo) ** frac
                else:
                    est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            seen += c
        return self.max


class Telemetry:
    """Aggregated serving-runtime metrics for one run."""

    def __init__(self, member_names: Sequence[str]):
        self.member_names = list(member_names)
        k = len(self.member_names)
        self.member_counts = np.zeros(k, np.int64)
        self.member_spend = np.zeros(k, np.float64)
        self.member_tokens = np.zeros(k, np.int64)
        self.generate_calls = 0
        self.score_batches = 0
        self.scored_requests = 0
        self.completed = 0
        self.rejected = 0
        self.expired = 0
        self.shed = 0            # SLO-class load shedding (queue.shed)
        self.routing_latency = Histogram()    # wall s per score batch
        self.queue_wait = Histogram()         # virtual s, true queued time
        #                                       (sum of per-leg waits, never
        #                                       earlier legs' service time)
        self.e2e_latency = Histogram()        # virtual s, arrival -> finish
        self.batch_size_sum = 0               # generate micro-batch sizes
        self.max_queue_depth = 0
        self.depth_samples = 0
        # Cascade (multi-leg) accounting, indexed by leg number - 1. Lists
        # grow on demand (max_legs is small and operator-bounded).
        self.leg_served: list = []            # legs served at leg n
        self.leg_spend: list = []             # $ spent on leg n
        self.leg_quality_sum: list = []       # observed/estimated quality
        self.leg_latency: list = []           # Histogram per leg (e2e at
        #                                       that leg's completion)
        self.escalations = 0
        self.finalized_by_leg: list = []      # requests finalized after leg n
        self.double_finalize_blocked = 0      # idempotence guard trips
        # Semantic cache (cascade rung 0) counters: hits served at zero
        # marginal cost, misses (no entry in radius OR policy fell
        # through to the ladder), and stale hits (drift-invalidated
        # entries that were NOT served).
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_stale = 0
        # Bounded whole-run time series: effective lambda per dispatch
        # round and queue depth per loop tick. Deterministically thinned,
        # never ring-truncated — the start of the run stays inspectable.
        self.lam_trace = BoundedSeries(cap=4096)
        self.depth_trace = BoundedSeries(cap=4096)

    def sync_members(self, names: Sequence[str]) -> None:
        """Re-align per-member counters with the (hot-mutated) pool.

        Columns follow member *names*: a hot-added member gets fresh
        zeroed counters, a surviving member keeps its history, and a
        removed member's history is dropped (its index would otherwise be
        silently re-attributed to whichever member shifted into it).
        """
        names = list(names)
        if names == self.member_names:
            return
        # Each old column is consumed at most once, so duplicate member
        # names map first-come and extras start zeroed instead of cloning
        # one member's history into every same-named column.
        pools: Dict[str, list] = {}
        for i, n in enumerate(self.member_names):
            pools.setdefault(n, []).append(i)
        src = [pools[n].pop(0) if pools.get(n) else None for n in names]

        def realign(arr, dtype):
            out = np.zeros(len(names), dtype)
            for i, j in enumerate(src):
                if j is not None:
                    out[i] = arr[j]
            return out

        self.member_counts = realign(self.member_counts, np.int64)
        self.member_spend = realign(self.member_spend, np.float64)
        self.member_tokens = realign(self.member_tokens, np.int64)
        self.member_names = names

    def merge(self, other: "Telemetry") -> None:
        """Fold another run's telemetry in (multi-worker rollup).

        Member columns are matched by *name*; the other run's members must
        be a subset-compatible view of the same pool (workers of one
        serving plane share the pool, so this is the common case).
        """
        if other.member_names != self.member_names:
            self.sync_members(list(dict.fromkeys(
                self.member_names + other.member_names)))
        col = {n: i for i, n in enumerate(self.member_names)}
        for j, name in enumerate(other.member_names):
            i = col[name]
            self.member_counts[i] += other.member_counts[j]
            self.member_spend[i] += other.member_spend[j]
            self.member_tokens[i] += other.member_tokens[j]
        self.generate_calls += other.generate_calls
        self.score_batches += other.score_batches
        self.scored_requests += other.scored_requests
        self.completed += other.completed
        self.rejected += other.rejected
        self.expired += other.expired
        self.shed += other.shed
        self.batch_size_sum += other.batch_size_sum
        self.max_queue_depth = max(self.max_queue_depth,
                                   other.max_queue_depth)
        self.depth_samples += other.depth_samples
        self.escalations += other.escalations
        self.double_finalize_blocked += other.double_finalize_blocked
        self.cache_hits += other.cache_hits
        self.cache_misses += other.cache_misses
        self.cache_stale += other.cache_stale
        self._grow_legs(len(other.leg_served))
        for i in range(len(other.leg_served)):
            self.leg_served[i] += other.leg_served[i]
            self.leg_spend[i] += other.leg_spend[i]
            self.leg_quality_sum[i] += other.leg_quality_sum[i]
            self.leg_latency[i].merge(other.leg_latency[i])
            self.finalized_by_leg[i] += other.finalized_by_leg[i]
        self.routing_latency.merge(other.routing_latency)
        self.queue_wait.merge(other.queue_wait)
        self.e2e_latency.merge(other.e2e_latency)
        self.lam_trace.merge(other.lam_trace)
        self.depth_trace.merge(other.depth_trace)

    @classmethod
    def rollup(cls, parts: Sequence["Telemetry"]) -> "Telemetry":
        """Aggregate per-worker telemetry into one plane-level view."""
        if not parts:
            return cls([])
        out = cls(parts[0].member_names)
        for t in parts:
            out.merge(t)
        return out

    # -- recording ----------------------------------------------------------

    def record_score_batch(self, n_requests: int, wall_s: float) -> None:
        self.score_batches += 1
        self.scored_requests += n_requests
        self.routing_latency.record(wall_s)

    def record_generate(self, member: int, n_requests: int, tokens: int,
                        cost: float) -> None:
        self.generate_calls += 1
        self.batch_size_sum += n_requests
        self.member_counts[member] += n_requests
        self.member_tokens[member] += tokens
        self.member_spend[member] += cost

    def record_cache(self, outcome: str) -> None:
        """Count one semantic-cache lookup outcome: hit | miss | stale."""
        if outcome == "hit":
            self.cache_hits += 1
        elif outcome == "stale":
            self.cache_stale += 1
        else:
            self.cache_misses += 1

    def record_completion(self, queue_wait_s: float, e2e_s: float,
                          exemplar: Optional[int] = None) -> None:
        self.completed += 1
        self.queue_wait.record(queue_wait_s, exemplar=exemplar)
        self.e2e_latency.record(e2e_s, exemplar=exemplar)

    def finalize_request(self, req) -> bool:
        """Idempotent completion accounting for one request.

        A re-admitted cascade leg flows through the completion path again;
        this is the single guard making sure a request can never be counted
        twice in the completion counters / latency histograms, no matter
        how many legs it ran or how a buggy caller double-drives the
        finalize path. Returns False (and counts the block) on a repeat.
        """
        if req.finalized:
            self.double_finalize_blocked += 1
            return False
        req.finalized = True
        self.record_completion(
            req.queue_wait_s, req.e2e_latency_s,
            exemplar=req.trace_key if req.trace_key >= 0 else None)
        # Per-leg attribution only once cascade accounting is live (a
        # record_leg call or a multi-leg request) — plain single-shot runs
        # keep their summary free of cascade keys.
        if self.leg_served or req.leg > 1:
            leg = max(int(req.leg), 1)
            self._grow_legs(leg)
            self.finalized_by_leg[leg - 1] += 1
        return True

    # -- cascade (multi-leg) accounting --------------------------------------

    def _grow_legs(self, n_legs: int) -> None:
        while len(self.leg_served) < n_legs:
            self.leg_served.append(0)
            self.leg_spend.append(0.0)
            self.leg_quality_sum.append(0.0)
            self.leg_latency.append(Histogram())
            self.finalized_by_leg.append(0)

    def record_leg(self, leg: int, cost: float, quality: float,
                   latency_s: float) -> None:
        """One completed cascade leg (leg numbering starts at 1)."""
        self._grow_legs(leg)
        i = leg - 1
        self.leg_served[i] += 1
        self.leg_spend[i] += cost
        self.leg_quality_sum[i] += quality
        self.leg_latency[i].record(latency_s)

    def record_escalation(self) -> None:
        self.escalations += 1

    def record_queue_depth(self, now: float, depth: int) -> None:
        self.max_queue_depth = max(self.max_queue_depth, depth)
        self.depth_samples += 1
        self.depth_trace.append(now, float(depth))

    def record_lambda(self, now: float, lam: float) -> None:
        self.lam_trace.append(now, float(lam))

    # -- reporting ----------------------------------------------------------

    @property
    def total_spend(self) -> float:
        return float(self.member_spend.sum())

    def summary(self, duration_s: Optional[float] = None) -> Dict:
        out = {
            "completed": self.completed,
            "rejected": self.rejected,
            "expired": self.expired,
            "shed": self.shed,
            "per_member_counts": dict(
                zip(self.member_names, self.member_counts.tolist())),
            "per_member_spend": dict(
                zip(self.member_names, self.member_spend.tolist())),
            "total_spend": self.total_spend,
            "generate_calls": self.generate_calls,
            "score_batches": self.score_batches,
            "mean_generate_batch": (self.batch_size_sum / self.generate_calls
                                    if self.generate_calls else 0.0),
            "routing_p50_ms": self.routing_latency.percentile(50) * 1e3,
            "routing_p99_ms": self.routing_latency.percentile(99) * 1e3,
            "queue_wait_p50_ms": self.queue_wait.percentile(50) * 1e3,
            "queue_wait_p99_ms": self.queue_wait.percentile(99) * 1e3,
            "e2e_p50_ms": self.e2e_latency.percentile(50) * 1e3,
            "e2e_p99_ms": self.e2e_latency.percentile(99) * 1e3,
            "max_queue_depth": self.max_queue_depth,
        }
        if self.leg_served:
            out["legs_served"] = list(self.leg_served)
            out["leg_spend"] = list(self.leg_spend)
            out["leg_mean_quality"] = [
                (qs / n if n else float("nan"))
                for qs, n in zip(self.leg_quality_sum, self.leg_served)]
            out["leg_e2e_p50_ms"] = [
                h.percentile(50) * 1e3 for h in self.leg_latency]
            out["finalized_by_leg"] = list(self.finalized_by_leg)
            out["escalations"] = self.escalations
            out["escalation_rate"] = (self.escalations / self.completed
                                      if self.completed else 0.0)
            out["double_finalize_blocked"] = self.double_finalize_blocked
        lookups = self.cache_hits + self.cache_misses + self.cache_stale
        if lookups:
            out["cache_hits"] = self.cache_hits
            out["cache_misses"] = self.cache_misses
            out["cache_stale"] = self.cache_stale
            out["cache_hit_rate"] = self.cache_hits / lookups
        if duration_s:
            out["duration_s"] = duration_s
            out["requests_per_s"] = self.completed / duration_s
        return out

    def report(self, duration_s: Optional[float] = None) -> str:
        s = self.summary(duration_s)
        shed = f"  shed {s['shed']}" if s["shed"] else ""
        lines = [
            f"completed {s['completed']}  rejected {s['rejected']}  "
            f"expired {s['expired']}{shed}",
            "per-member counts: " + "  ".join(
                f"{n}={c}" for n, c in s["per_member_counts"].items()),
            "per-member spend:  " + "  ".join(
                f"{n}=${v:.6f}" for n, v in s["per_member_spend"].items()),
            f"total spend ${s['total_spend']:.6f}   "
            f"generate calls {s['generate_calls']} "
            f"(mean batch {s['mean_generate_batch']:.1f})",
            f"routing latency p50 {s['routing_p50_ms']:.2f}ms  "
            f"p99 {s['routing_p99_ms']:.2f}ms  "
            f"({s['score_batches']} score batches)",
            f"queue wait p50 {s['queue_wait_p50_ms']:.1f}ms  "
            f"p99 {s['queue_wait_p99_ms']:.1f}ms   "
            f"e2e p50 {s['e2e_p50_ms']:.1f}ms  p99 {s['e2e_p99_ms']:.1f}ms",
            f"max queue depth {s['max_queue_depth']}",
        ]
        if self.leg_served:
            per_leg = "  ".join(
                f"L{i + 1}: n={n} ${sp:.6f} q={mq:.3f} p50={p50:.1f}ms"
                for i, (n, sp, mq, p50) in enumerate(zip(
                    s["legs_served"], s["leg_spend"],
                    s["leg_mean_quality"], s["leg_e2e_p50_ms"])))
            lines.append(f"cascade legs: {per_leg}")
            lines.append(
                f"escalations {s['escalations']} "
                f"(rate {s['escalation_rate']:.3f})  finalized by leg "
                + "/".join(str(n) for n in s["finalized_by_leg"]))
        if duration_s:
            lines.append(f"duration {s['duration_s']:.2f}s  "
                         f"throughput {s['requests_per_s']:.1f} req/s")
        return "\n".join(lines)
