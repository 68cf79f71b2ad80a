"""Staged/delayed quality-feedback outcomes for the online loop.

The original ``OnlineAdapter`` assumed quality feedback is available the
moment a request completes (``quality_feedback(request) -> float``). Real
feedback signals — user ratings, auto-eval verdicts, downstream task
success — lag completion by seconds to hours and arrive out of order. This
module is the staging layer between completion and training:

  * ``quality_feedback`` may now return **None**, parking the outcome in an
    :class:`OutcomeStage` instead of training on a placeholder score;
  * the real score arrives later via
    ``OnlineAdapter.deliver_feedback(rid, s_obs)`` — in any order, even
    *before* the outcome was staged (the feedback channel can race the
    serving thread);
  * every scheduler dispatch round calls ``OnlineAdapter.tick(now)``, which
    flushes resolved outcomes in their original staged order (deterministic
    replay under a fixed seed) and expires outcomes whose feedback never
    arrived within ``timeout_s`` — they are *dropped*, never trained on a
    guessed score.

The cross-worker replay merge (``distributed/coordinator.py``) consumes
exactly what this layer commits: a worker's replay buffer only ever holds
real observed scores, so the leader's merged updates are placeholder-free
by construction.

The port of ``repro.online.staging``, a copy: pure host code; the
simulator's jitter comes from the same seeded numpy generator.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class _Staged:
    req: object
    staged_t: float
    seq: int
    s_obs: Optional[float] = None


class OutcomeStage:
    """Pending-outcome staging area with out-of-order tolerant delivery.

    ``timeout_s`` bounds how long an unresolved outcome is held (expired
    outcomes are dropped, never trained on a guess); None holds pending
    outcomes indefinitely — only safe when the feedback channel is
    guaranteed to deliver (e.g. the synchronous simulators). Early
    deliveries for never-staged rids are additionally FIFO-capped at
    ``early_capacity`` so a crashed-and-rejoined worker's orphaned
    feedback can't grow without bound.
    """

    def __init__(self, timeout_s: Optional[float] = None,
                 early_capacity: int = 4096):
        self.timeout_s = timeout_s
        self.early_capacity = early_capacity
        self._pending: Dict[int, _Staged] = {}
        # Feedback that arrived before its outcome was staged: rid -> (s, t).
        self._early: Dict[int, Tuple[float, float]] = {}
        self._seq = 0
        self.staged = 0
        self.resolved = 0
        self.expired = 0
        self.early_deliveries = 0

    def __len__(self) -> int:
        return len(self._pending)

    def stage(self, req, now: float) -> None:
        """Park a completed request until its quality feedback arrives."""
        entry = _Staged(req, float(now), self._seq)
        self._seq += 1
        self.staged += 1
        rid = int(req.rid)
        if rid in self._early:                 # feedback raced completion
            entry.s_obs = self._early.pop(rid)[0]
            self.resolved += 1
        self._pending[rid] = entry

    def deliver(self, rid: int, s_obs: float, now: float = 0.0) -> None:
        """Attach a score to a staged outcome; unknown rids are held as
        early deliveries (out-of-order tolerance), never an error."""
        entry = self._pending.get(int(rid))
        if entry is None:
            self._early[int(rid)] = (float(s_obs), float(now))
            self.early_deliveries += 1
            while len(self._early) > self.early_capacity:   # FIFO bound
                del self._early[next(iter(self._early))]
            return
        if entry.s_obs is None:
            self.resolved += 1
        entry.s_obs = float(s_obs)

    def flush(self, now: float) -> List[Tuple[object, float]]:
        """Resolved outcomes in staged order; expires timed-out entries.

        Staged order (not delivery order) keeps the committed stream
        deterministic regardless of how the feedback channel interleaved.
        """
        ready, dead = [], []
        for rid, e in self._pending.items():
            if e.s_obs is not None:
                ready.append((e.seq, rid, e))
            elif (self.timeout_s is not None
                  and now - e.staged_t > self.timeout_s):
                dead.append(rid)
        for rid in dead:
            del self._pending[rid]
            self.expired += 1
        if self.timeout_s is not None:
            self._early = {r: (s, t) for r, (s, t) in self._early.items()
                           if now - t <= self.timeout_s}
        out = []
        for _, rid, e in sorted(ready):
            del self._pending[rid]
            out.append((e.req, e.s_obs))
        return out


class DelayedFeedback:
    """Simulator: ground-truth scores that arrive ``delay_s`` after a
    request finishes (plus optional jitter, which reorders deliveries).

    Install as both the adapter's ``quality_feedback`` and its
    ``feedback_source``: calls return None (staging the outcome) while the
    true score is queued for delivery at ``finish_s + delay``; the
    adapter's ``tick()`` drains :meth:`due` each dispatch round.
    """

    def __init__(self, truth_fn: Callable[[object], float], delay_s: float,
                 *, jitter_s: float = 0.0, seed: int = 0):
        self.truth_fn = truth_fn
        self.delay_s = float(delay_s)
        self.jitter_s = float(jitter_s)
        self.rng = np.random.default_rng(seed)
        self._heap: List[Tuple[float, int, int, float]] = []
        self._n = 0

    def __call__(self, req) -> None:
        t = float(req.finish_s) + self.delay_s
        if self.jitter_s:
            t += float(self.rng.uniform(0.0, self.jitter_s))
        heapq.heappush(self._heap,
                       (t, self._n, int(req.rid), float(self.truth_fn(req))))
        self._n += 1
        return None

    def due(self, now: float) -> List[Tuple[int, float]]:
        out = []
        while self._heap and self._heap[0][0] <= now:
            _, _, rid, s = heapq.heappop(self._heap)
            out.append((rid, s))
        return out

    @property
    def in_flight(self) -> int:
        return len(self._heap)
