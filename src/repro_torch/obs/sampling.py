"""Deterministic head+tail trace sampling for heavy traffic.

The port's copy of ``repro.obs.sampling``, pure Python: the same events, series
and bytes as the reference's for the same inputs.

A plain recorder keeps every event of every request — correct for seeded
acceptance runs, unbounded for a real fleet. Streaming mode bounds it with
three mechanisms, applied at *request* granularity so span trees stay whole:

  * **Head sampling** (:class:`TraceSampler`): the keep/drop decision is a
    pure function of the request's admission-order trace key and a seed —
    a seeded ``blake2b`` hash mapped to [0, 1) and compared against the
    sample rate. No RNG state, no wall clock: the keep-set of a seeded run
    is bit-identical across replays, and two workers sharing a recorder
    agree for free. The first ``head`` keys are always kept (the start of
    a run is where config mistakes show up).
  * **Tail lane** (:func:`is_anomaly_event`): requests that did something
    anomalous — escalated up the cascade, expired or were deadline-rescued
    — are always kept regardless of the sample rate. The recorder flags
    the key the moment an anomaly event is recorded; the sampling decision
    is deferred to drain time, after the tail is known. Runtime-scope
    anomalies (drift alarms, budget tighten/throttle verdicts, worker
    crash/rejoin) carry no request key and are never sampled at all.
  * **Hard cap** (``TraceRecorder(max_buffered_per_worker=...)``): a
    per-worker bound on buffered events. When a worker hits it, new
    request trees are *shed* (dropped whole, with drop accounting) until a
    flush makes room. The cap wins over the always-keep lane — it is the
    memory-safety backstop, and a shed anomaly is counted, not silent.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Optional, Set

# Request-scope event names that flag the request's tree as anomalous
# (tail-sampling always-keep lane). Runtime-scope events (no request key)
# are never subject to sampling, so they need no entry here even when
# anomalous (drift_alarm, worker_crash/rejoin, governor verdicts).
ANOMALY_EVENTS = frozenset({"readmit", "expire", "rescued"})

# Root-span statuses / flags that mark the tree anomalous at finalize.
_ANOMALY_STATUS = frozenset({"expired"})


def is_anomaly_event(name: str, args: Optional[dict]) -> bool:
    """True when recording this event must pin its request in the trace."""
    if name in ANOMALY_EVENTS:
        return True
    if name == "request" and args:
        return bool(args.get("rescued")) or (
            args.get("status") in _ANOMALY_STATUS)
    return False


class TraceSampler:
    """Deterministic per-request keep/drop decision.

    ``keep(key)`` is a pure function of ``(seed, key)``: a replay with the
    same seed and the same admission order reproduces the identical
    keep-set. ``rate`` is the asymptotic fraction of request trees kept;
    the first ``head`` keys are always kept.
    """

    def __init__(self, rate: float, *, seed: int = 0, head: int = 8):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"sample rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.seed = int(seed)
        self.head = int(head)
        self._key = self.seed.to_bytes(8, "little", signed=True)

    def keep(self, key: int) -> bool:
        if key < self.head or self.rate >= 1.0:
            return True
        if self.rate <= 0.0:
            return False
        h = hashlib.blake2b(int(key).to_bytes(8, "little", signed=True),
                            key=self._key, digest_size=8).digest()
        return int.from_bytes(h, "little") / 2.0 ** 64 < self.rate

    def keep_set(self, keys: Iterable[int]) -> Set[int]:
        return {k for k in keys if self.keep(k)}

    def describe(self) -> dict:
        return {"rate": self.rate, "seed": self.seed, "head": self.head}
