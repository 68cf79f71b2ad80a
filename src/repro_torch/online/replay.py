"""Fixed-capacity outcome replay buffer for online router adaptation.

Stores ``(q_emb, member, s_obs, c_obs, t)`` tuples emitted by the serving
scheduler. Two regions under one capacity:

  * a **recency ring** holding the newest outcomes verbatim — the signal
    that matters most under drift;
  * a **reservoir** fed by items aging out of the ring, maintaining a
    uniform sample over the whole evicted stream (Vitter's Algorithm R) —
    the anchor that stops the updater from catastrophically forgetting the
    stationary part of the distribution.

Sampling is recency-stratified: a configurable fraction of each batch comes
from the ring, the rest from the reservoir. All randomness flows from one
seeded ``numpy`` Generator, so buffer contents and samples replay
identically under a fixed seed and add/sample order.

The port of ``repro.online.replay``, a copy: host numpy and the same
seeded generator, so the same adds, drops and seed give the reference's
samples draw for draw.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

# One stored outcome: (q_emb, member, s_obs, c_obs, t).
_Item = Tuple[np.ndarray, int, float, float, float]


class ReplayBuffer:
    def __init__(self, capacity: int = 4096, *, recent_frac: float = 0.25,
                 seed: int = 0):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        if not 0.0 < recent_frac < 1.0:
            raise ValueError("recent_frac must be in (0, 1)")
        self.capacity = capacity
        self.cap_recent = max(1, int(round(capacity * recent_frac)))
        self.cap_reservoir = capacity - self.cap_recent
        self.rng = np.random.default_rng(seed)
        self._recent: Deque[_Item] = deque()
        self._reservoir: List[_Item] = []
        self._evicted = 0      # length of the stream feeding the reservoir
        self.added = 0

    def __len__(self) -> int:
        return len(self._recent) + len(self._reservoir)

    # -- writes --------------------------------------------------------------

    def add(self, q_emb: np.ndarray, member: int, s_obs: float,
            c_obs: float, t: float = 0.0) -> None:
        item = (np.asarray(q_emb, np.float32), int(member), float(s_obs),
                float(c_obs), float(t))
        self.added += 1
        self._recent.append(item)
        if len(self._recent) > self.cap_recent:
            self._reservoir_add(self._recent.popleft())

    def _reservoir_add(self, item: _Item) -> None:
        self._evicted += 1
        if len(self._reservoir) < self.cap_reservoir:
            self._reservoir.append(item)
            return
        j = int(self.rng.integers(self._evicted))
        if j < self.cap_reservoir:
            self._reservoir[j] = item

    def drop_member(self, idx: int) -> None:
        """Hot pool removal: discard the member's outcomes, shift indices
        of members above it down by one (matching the mutated pool)."""
        def remap(items):
            return [(q, m - (m > idx), s, c, t) for (q, m, s, c, t) in items
                    if m != idx]
        self._recent = deque(remap(self._recent))
        self._reservoir = remap(self._reservoir)

    # -- reads ---------------------------------------------------------------

    def member_counts(self, n_members: int) -> np.ndarray:
        counts = np.zeros(n_members, np.int64)
        for _, m, _, _, _ in list(self._recent) + self._reservoir:
            if m < n_members:
                counts[m] += 1
        return counts

    def sample(self, n: int, *, recent_frac: float = 0.5) -> Optional[Dict]:
        """Recency-stratified batch of ``n`` outcomes (with replacement).

        Returns ``{"q_emb" (n,dq), "member" (n,), "s" (n,), "c" (n,),
        "t" (n,)}`` or None when the buffer is empty. Strata fall back on
        each other while one side is still sparse.
        """
        if len(self) == 0:
            return None
        recent = list(self._recent)
        n_rec = int(round(n * recent_frac))
        if not self._reservoir:
            n_rec = n
        elif not recent:
            n_rec = 0
        picks: List[_Item] = []
        if n_rec:
            idx = self.rng.integers(len(recent), size=n_rec)
            picks.extend(recent[i] for i in idx)
        if n - n_rec:
            idx = self.rng.integers(len(self._reservoir), size=n - n_rec)
            picks.extend(self._reservoir[i] for i in idx)
        return {
            "q_emb": np.stack([p[0] for p in picks]),
            "member": np.asarray([p[1] for p in picks], np.int32),
            "s": np.asarray([p[2] for p in picks], np.float32),
            "c": np.asarray([p[3] for p in picks], np.float32),
            "t": np.asarray([p[4] for p in picks], np.float64),
        }
