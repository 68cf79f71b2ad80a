"""SLO monitors with multi-window burn-rate alerting on the virtual clock.

The port's copy of ``repro.obs.slo``, pure Python: the same events, series
and bytes as the reference's for the same inputs.

Each SLO is stated as an *error budget*: the fraction of requests allowed
to be "bad" over a compliance window ("p95 e2e latency <= 2s" is "at most
5% of requests slower than 2s"; deadline-miss rate and quality floor are
direct bad-fractions; the $/window budget is a spend rate). The **burn
rate** is how fast the budget is being consumed relative to plan::

    burn = bad_fraction / error_budget        (1.0 = exactly on budget)
    burn = spend_rate   / budgeted_rate       (spend SLOs)

Following the multi-window pattern (Google SRE workbook), an alert fires
only when the burn exceeds the threshold over **both** a short window
(fast detection, catches ongoing incidents) and a long window (resists
blips: a single slow request in a quiet period spikes the short-window
fraction but not the long one). All windows run on the runtime's virtual
clock via bucketed rolling counters, so a seeded run fires the identical
alerts at identical virtual times on every replay — and the bucket map is
tolerant of the mildly out-of-order completion times a multi-worker plane
produces.

:class:`SLOTracker` bundles the standard four (latency, deadline-miss,
quality floor, spend), observes each finalized request once, emits
``slo_alert`` trace instants on firing/resolved transitions, and exposes
live burn rates for :func:`repro_torch.obs.wiring.register_slo_metrics`.
"""
from __future__ import annotations

from typing import Dict, List, Optional


class RollingWindow:
    """Bucketed rolling (count, bad, value) totals over virtual time.

    O(n_buckets) memory; observations may arrive out of order (cross-worker
    completion skew) — anything newer than ``hi - window`` still lands in
    its correct bucket.
    """

    def __init__(self, window_s: float, n_buckets: int = 30):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        self.window_s = float(window_s)
        self.width = self.window_s / int(n_buckets)
        self._buckets: Dict[int, List[float]] = {}
        self._hi = None  # highest bucket index seen

    def add(self, t: float, *, bad: int = 0, value: float = 0.0,
            n: int = 1) -> None:
        idx = int(t // self.width)
        b = self._buckets.get(idx)
        if b is None:
            b = self._buckets[idx] = [0, 0, 0.0]
        b[0] += n
        b[1] += bad
        b[2] += value
        if self._hi is None or idx > self._hi:
            self._hi = idx
            # Prune on high-water advance: drop buckets that can no longer
            # intersect any window ending >= hi's bucket start.
            lo = idx - int(self.window_s / self.width) - 1
            for k in [k for k in self._buckets if k < lo]:
                del self._buckets[k]

    def totals(self, now: float) -> List[float]:
        """(count, bad, value) over ``(now - window_s, now]``."""
        lo = int((now - self.window_s) // self.width)
        n = bad = 0
        val = 0.0
        for idx, b in self._buckets.items():
            if idx > lo:
                n += b[0]
                bad += b[1]
                val += b[2]
        return [n, bad, val]


class BurnRateSLO:
    """Bad-fraction SLO with short+long window burn-rate alerting."""

    kind = "ratio"

    def __init__(self, name: str, *, error_budget: float,
                 short_s: float, long_s: float, threshold: float = 1.0,
                 min_events: int = 1):
        if not 0.0 < error_budget <= 1.0:
            raise ValueError("error_budget must be in (0, 1]")
        if short_s >= long_s:
            raise ValueError("short window must be shorter than long")
        self.name = name
        self.error_budget = float(error_budget)
        self.threshold = float(threshold)
        self.min_events = int(min_events)
        self.short = RollingWindow(short_s)
        self.long = RollingWindow(long_s)
        self.firing = False

    def observe(self, t: float, bad: bool) -> None:
        self.short.add(t, bad=int(bad))
        self.long.add(t, bad=int(bad))

    def _burn(self, win: RollingWindow, now: float) -> float:
        n, bad, _ = win.totals(now)
        if n < self.min_events:
            return 0.0
        return (bad / n) / self.error_budget

    def burns(self, now: float) -> Dict[str, float]:
        return {"short": self._burn(self.short, now),
                "long": self._burn(self.long, now)}

    def evaluate(self, now: float) -> bool:
        """Current alert condition (both windows over threshold)."""
        b = self.burns(now)
        return (b["short"] >= self.threshold
                and b["long"] >= self.threshold)


class SpendBurnSLO:
    """$/window SLO: spend rate vs the budgeted rate, short+long windows."""

    kind = "spend"

    def __init__(self, name: str, *, budget: float, window_s: float,
                 short_s: Optional[float] = None, threshold: float = 1.0):
        if budget <= 0:
            raise ValueError("budget must be > 0")
        self.name = name
        self.budget = float(budget)           # allowed spend per window_s
        self.window_s = float(window_s)
        self.threshold = float(threshold)
        self.short = RollingWindow(short_s if short_s is not None
                                   else max(window_s / 12.0, 1e-9))
        self.long = RollingWindow(window_s)
        self.firing = False

    def observe(self, t: float, cost: float) -> None:
        self.short.add(t, value=float(cost))
        self.long.add(t, value=float(cost))

    def _burn(self, win: RollingWindow, now: float) -> float:
        _, _, spend = win.totals(now)
        allowed = self.budget * (win.window_s / self.window_s)
        return spend / allowed if allowed > 0 else 0.0

    def burns(self, now: float) -> Dict[str, float]:
        return {"short": self._burn(self.short, now),
                "long": self._burn(self.long, now)}

    def evaluate(self, now: float) -> bool:
        b = self.burns(now)
        return (b["short"] >= self.threshold
                and b["long"] >= self.threshold)


class SLOTracker:
    """The run's SLO set: observe finalized requests, alert on transitions.

    ``check(now)`` evaluates every SLO and records a transition event
    (``state: firing|resolved``) whenever the multi-window condition flips,
    emitting it as a runtime-scope ``slo_alert`` trace instant when a
    tracer is attached. Alert history accumulates in :attr:`alerts`.
    """

    def __init__(self, slos, *, tracer=None, check_every_s: float = 1.0):
        self.slos = list(slos)
        self.tracer = tracer
        self.check_every_s = float(check_every_s)
        self.alerts: List[Dict] = []
        self.alerts_total = 0
        self._next_check: Optional[float] = None

    def observe_request(self, t: float, *, e2e_s: float, missed: bool,
                        quality: Optional[float], cost: float,
                        quality_floor: Optional[float] = None) -> None:
        for s in self.slos:
            if s.kind == "spend":
                s.observe(t, cost)
            elif s.name == "latency_p95":
                s.observe(t, bad=e2e_s > s.target_s)
            elif s.name == "deadline_miss":
                s.observe(t, bad=missed)
            elif s.name == "quality_floor":
                if quality is not None:
                    s.observe(t, bad=quality < s.floor)
            else:
                s.observe(t, bad=missed)

    def check(self, now: float, force: bool = False) -> List[Dict]:
        """Throttled evaluation; returns this call's transition records."""
        if not force:
            if self._next_check is not None and now < self._next_check:
                return []
            self._next_check = now + self.check_every_s
        out: List[Dict] = []
        for s in self.slos:
            state = s.evaluate(now)
            if state == s.firing:
                continue
            s.firing = state
            b = s.burns(now)
            rec = {"slo": s.name, "state": "firing" if state else "resolved",
                   "t": now, "burn_short": round(b["short"], 6),
                   "burn_long": round(b["long"], 6)}
            out.append(rec)
            self.alerts.append(rec)
            self.alerts_total += 1
            if self.tracer is not None:
                self.tracer.instant(
                    "slo_alert", "slo", now,
                    args={k: v for k, v in rec.items() if k != "t"})
        return out

    def firing(self) -> List[str]:
        return [s.name for s in self.slos if s.firing]

    def burn_rates(self, now: float) -> Dict[str, Dict[str, float]]:
        return {s.name: s.burns(now) for s in self.slos}


def build_slo_tracker(*, tracer=None, p95_target_s: Optional[float] = None,
                      p95_budget: float = 0.05,
                      miss_rate_budget: Optional[float] = None,
                      quality_floor: Optional[float] = None,
                      quality_budget: float = 0.10,
                      spend_per_window: Optional[float] = None,
                      window_s: float = 600.0, threshold: float = 1.0,
                      check_every_s: Optional[float] = None
                      ) -> Optional[SLOTracker]:
    """Standard four-SLO tracker from launch flags; None if nothing set.

    The short window is long/12 (the SRE workbook's 5m:1h ratio). Windows
    are in *virtual* seconds — the simulated deployment's service model
    runs whole traces in sub-second virtual time, so pass windows on that
    scale (e.g. ``--slo-window 0.1``). ``check_every_s`` defaults to half
    the short window.
    """
    short_s = window_s / 12.0
    slos = []
    if p95_target_s is not None:
        s = BurnRateSLO("latency_p95", error_budget=p95_budget,
                        short_s=short_s, long_s=window_s,
                        threshold=threshold)
        s.target_s = float(p95_target_s)
        slos.append(s)
    if miss_rate_budget is not None:
        slos.append(BurnRateSLO("deadline_miss",
                                error_budget=miss_rate_budget,
                                short_s=short_s, long_s=window_s,
                                threshold=threshold))
    if quality_floor is not None:
        s = BurnRateSLO("quality_floor", error_budget=quality_budget,
                        short_s=short_s, long_s=window_s,
                        threshold=threshold)
        s.floor = float(quality_floor)
        slos.append(s)
    if spend_per_window is not None:
        slos.append(SpendBurnSLO("spend", budget=spend_per_window,
                                 window_s=window_s, short_s=short_s,
                                 threshold=threshold))
    if not slos:
        return None
    if check_every_s is None:
        check_every_s = short_s / 2.0
    return SLOTracker(slos, tracer=tracer, check_every_s=check_every_s)
