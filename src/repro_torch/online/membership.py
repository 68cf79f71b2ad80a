"""Hot pool membership: add/remove serving members at runtime.

Adding a member mid-stream poses two problems the offline pipeline never
sees: the router has no model embedding for it (those come from observed
quality over training clusters, paper §5), and its predictions are
untrained. The tracker solves both:

  * the new member's embedding row cold-starts at the pool mean and is
    then replaced cluster-by-cluster with *observed* mean quality — each
    outcome is assigned to its nearest k-means centroid (the same
    centroids, carried on the router, that built the offline embeddings —
    exactly :func:`repro_torch.core.model_repr.embed_new_model`,
    incrementalized);
  * until the member has ``min_outcomes`` observed outcomes it is
    **probationary**: masked out of the exploitation argmax and reachable
    only through the exploration policy, so cold predictions never steer
    real traffic.

Removal shifts member indices down; the tracker propagates the remap to
the replay buffer and exploration counts so stale indices can't dangle.

**Established-member refresh** (``refresh_established=True``): graduated
members' embedding rows normally adapt only through predictor gradients —
under drift the *embedding* itself (per-cluster observed mean quality,
paper §5) goes stale even while the predictor compensates. The flagged
path applies an EMA of observed outcomes to the graduated member's row in
the outcome's cluster, so the row tracks the member's live per-cluster
quality. Off by default: it changes long-standing rows, so the operator
opts in (``serve.py --refresh-established``).

The port of ``repro.online.membership``. The tracker's rows and counts
stay host numpy, as in the reference; the grown or shrunk router comes
from the port's ``PredictiveRouter.add_member`` / ``remove_member``, whose
predictor heads live on the router's device, and is published through
``RoutedEngine.swap_router``, which drops the cached pool projections so
the next scoring pass rebuilds them at the new K. A hot-added member's
own weights must already be on the engine's device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class MembershipTracker:
    def __init__(self, engine, *, min_outcomes: int = 25,
                 prior_weight: float = 1.0,
                 refresh_established: bool = False,
                 refresh_rate: float = 0.05):
        self.engine = engine
        self.min_outcomes = min_outcomes
        self.prior_weight = prior_weight
        self.refresh_established = refresh_established
        self.refresh_rate = refresh_rate
        k = len(engine.pool)
        # Offline-trained members are born graduated.
        self.counts = np.full(k, min_outcomes, np.int64)
        self.model_emb = np.array(engine.router.model_emb, np.float32,
                                  copy=True)
        # Per-probationary-member per-cluster (sum, n) accumulators.
        self._cluster_stats: Dict[int, Dict[str, np.ndarray]] = {}
        self._prior_rows: Dict[int, np.ndarray] = {}
        self.emb_dirty = False

    @property
    def n_members(self) -> int:
        return len(self.counts)

    def exploit_mask(self) -> np.ndarray:
        """(K,) bool — False while a member is probationary."""
        return self.counts >= self.min_outcomes

    def in_probation(self, idx: int) -> bool:
        return bool(self.counts[idx] < self.min_outcomes)

    # -- pool mutation -------------------------------------------------------

    def add_member(self, pool_member,
                   emb_row: Optional[np.ndarray] = None) -> int:
        """Append a member to the live pool; returns its index.

        Publishes a grown router (cold-started embedding row + expanded
        predictor heads) via the engine's atomic swap, then registers the
        member as probationary.
        """
        router = self.engine.router.add_member(emb_row)
        self.engine.pool.append(pool_member)
        self.engine.swap_router(router)
        idx = router.n_members - 1
        self.counts = np.append(self.counts, 0)
        self.model_emb = np.array(router.model_emb, np.float32, copy=True)
        c = self.model_emb.shape[1]
        self._cluster_stats[idx] = {"sum": np.zeros(c, np.float64),
                                    "n": np.zeros(c, np.int64)}
        self._prior_rows[idx] = self.model_emb[idx].copy()
        return idx

    def remove_member(self, idx: int, *, replay=None, policy=None) -> None:
        """Drop a member from the live pool and remap dependent state.

        Pool-list surgery and the router swap are two steps, so membership
        mutations must run between dispatch rounds (the adapter API is
        driven from the scheduler's thread). The router swaps first: in
        the transient window choices are bounded by the shrunk router, so
        a straggling scorer can never index past the end of the pool.
        """
        router = self.engine.router.remove_member(idx)
        self.engine.swap_router(router)
        del self.engine.pool[idx]
        self.counts = np.delete(self.counts, idx)
        self.model_emb = np.array(router.model_emb, np.float32, copy=True)
        self._cluster_stats = {
            m - (m > idx): st for m, st in self._cluster_stats.items()
            if m != idx}
        self._prior_rows = {
            m - (m > idx): row for m, row in self._prior_rows.items()
            if m != idx}
        if replay is not None:
            replay.drop_member(idx)
        if policy is not None:
            policy.remove_member(idx)

    # -- outcome accounting --------------------------------------------------

    def record_outcome(self, member: int, q_emb: np.ndarray,
                       s_obs: float) -> None:
        member = int(member)
        self.counts[member] += 1
        stats = self._cluster_stats.get(member)
        if stats is None and not self.refresh_established:
            return
        centroids = self.engine.router.centroids
        if centroids is None:
            return
        # Same nearest-centroid rule as core.clustering.assign_clusters,
        # inlined in numpy: this runs once per served outcome, where a
        # single-row device dispatch would dominate the cost.
        d2 = np.sum((np.asarray(centroids, np.float32)
                     - np.asarray(q_emb, np.float32)[None, :]) ** 2, axis=1)
        ci = int(np.argmin(d2))
        if stats is None:
            # Established member under the flagged refresh: EMA the row's
            # cluster entry toward the observed outcome, so drift in the
            # member's real per-cluster quality reaches the embedding
            # without waiting for predictor gradients to route around it.
            rho = self.refresh_rate
            self.model_emb[member, ci] = (
                (1.0 - rho) * self.model_emb[member, ci] + rho * float(s_obs))
            self.emb_dirty = True
            return
        stats["sum"][ci] += float(s_obs)
        stats["n"][ci] += 1
        prior = self._prior_rows[member][ci]
        w0 = self.prior_weight
        self.model_emb[member, ci] = (
            (w0 * prior + stats["sum"][ci]) / (w0 + stats["n"][ci]))
        self.emb_dirty = True
        if self.counts[member] >= self.min_outcomes:
            # Graduated: keep the observed row, stop accumulating (the
            # updater's gradient steps take over from here).
            del self._cluster_stats[member]
            del self._prior_rows[member]
