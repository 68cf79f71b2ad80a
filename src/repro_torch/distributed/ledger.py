"""Shared budget ledger: one $/window budget across N scheduler workers.

The port of ``repro.distributed.ledger`` (pure Python). ``LedgerClient`` is
the socket-mode follower's facade (``distributed/host.py``).

With per-worker :class:`~repro_torch.serving.budget.BudgetGovernor` instances,
"at most $B per window" silently becomes "$N*B per window" — each worker
only sees its own spend. The ledger is a single governor every worker
records into, so utilization and the effective lambda reflect the *global*
spend.

Two multi-worker wrinkles:

  * **controller cadence** — each worker calls ``update()`` once per
    dispatch round; N workers would apply N proportional controller steps
    per window and oscillate. The ledger throttles the controller to at
    most one step per ``update_min_interval_s`` of virtual time; throttled
    calls return the current lambda unchanged (workers still *read* a
    fresh effective lambda every round).
  * **clock skew** — workers advance independent virtual clocks, so spend
    events arrive slightly out of time order. The ledger clamps to a
    monotone high-water time, keeping the rolling-window deque sorted;
    the distortion is bounded by the worker skew, which the plane keeps
    well under the window length.
"""
from __future__ import annotations

from repro_torch.distributed import messages as M
from repro_torch.distributed.messages import Message
from repro_torch.serving.budget import BudgetGovernor


class SharedBudgetLedger(BudgetGovernor):
    def __init__(self, budget: float, window_s: float = 10.0, *,
                 update_min_interval_s: float = None, **kwargs):
        super().__init__(budget, window_s, **kwargs)
        self.update_min_interval_s = (
            window_s / 20.0 if update_min_interval_s is None
            else update_min_interval_s)
        self._now_hwm = 0.0
        self._last_ctrl = float("-inf")
        self.throttled = 0

    def _monotone(self, now: float) -> float:
        self._now_hwm = max(self._now_hwm, float(now))
        return self._now_hwm

    def record(self, cost: float, now: float) -> None:
        super().record(cost, self._monotone(now))

    def utilization(self, now: float) -> float:
        return super().utilization(self._monotone(now))

    def update(self, now: float) -> float:
        t = self._monotone(now)
        if t - self._last_ctrl < self.update_min_interval_s:
            self.throttled += 1
            self.last_action = "throttled"
            self.last_utilization = self.utilization(t)
            return self.lam
        self._last_ctrl = t
        return super().update(t)


class LedgerClient:
    """Remote-scheduler facade for a controller-side shared ledger.

    In socket mode the real :class:`SharedBudgetLedger` lives in the
    controller process; each follower's scheduler gets one of these as
    its ``governor``. Every call is one ``LEDGER_OP`` message to the
    ledger-owning endpoint, so "at most $B per window" stays a *global*
    property — N processes record into one rolling window, exactly like
    the in-process plane's shared object.

    The reply piggybacks the ledger's ``lam`` / ``last_action`` /
    ``last_utilization``, which the client caches: scheduler tracing and
    cascade headroom reads see fresh values without extra round trips.

    When the ledger endpoint becomes unreachable (controller loss) the
    client degrades permanently to its cached values instead of raising:
    a follower draining its queue solo keeps serving under the last
    effective lambda rather than crashing mid-request. Global budget
    enforcement is necessarily suspended while degraded — the spend a
    degraded follower records is lost to the window — which matches the
    plane's follower-local degradation semantics.
    """

    _UNREACHABLE = object()

    def __init__(self, transport, dst: int = 0):
        self.transport = transport
        self.dst = int(dst)
        self._lam = 0.0
        self.last_action = "init"
        self.last_utilization = 0.0
        self.last_headroom = 1.0
        self.degraded = False

    def _op(self, op: str, *args):
        from repro_torch.distributed.transport import TransportError

        if self.degraded:
            return self._UNREACHABLE
        try:
            rep = self.transport.request(Message(
                kind=M.LEDGER_OP, dst=self.dst,
                payload={"op": op, "args": list(args)}))
        except TransportError:
            self.degraded = True
            self.last_action = "degraded"
            return self._UNREACHABLE
        p = rep.payload
        self._lam = float(p.get("lam", self._lam))
        if p.get("last_action") is not None:
            self.last_action = p["last_action"]
        if p.get("last_utilization") is not None:
            self.last_utilization = p["last_utilization"]
        return p.get("result")

    @property
    def lam(self) -> float:
        return self._lam

    def update(self, now: float) -> float:
        r = self._op("update", now)
        return self._lam if r is self._UNREACHABLE else float(r)

    def record(self, cost: float, now: float) -> None:
        self._op("record", float(cost), now)

    def utilization(self, now: float) -> float:
        r = self._op("utilization", now)
        return self.last_utilization if r is self._UNREACHABLE else float(r)

    def headroom(self, now: float) -> float:
        r = self._op("headroom", now)
        if r is self._UNREACHABLE:
            return self.last_headroom
        self.last_headroom = float(r)
        return self.last_headroom

    def window_spend(self, now: float) -> float:
        r = self._op("window_spend", now)
        return 0.0 if r is self._UNREACHABLE else float(r)

    def summary(self, now: float) -> dict:
        r = self._op("summary", now)
        return {} if r is self._UNREACHABLE else r
