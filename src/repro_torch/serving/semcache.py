"""Semantic answer cache: rung 0 of the cascade ladder.

At millions-of-users traffic many queries are near-duplicates. This cache
keys *answers* by query embedding: when a new query lands within a
calibrated radius of a cached entry, the cached answer can be served at
zero marginal cost. Crucially the decision to serve it is NOT a bare
threshold — the cache is wired as the cheapest rung of the cascade
ladder, so stop-vs-escalate reasons about cache confidence with the same
expected-marginal-reward math as every other leg
(the cascade layer's ``CascadePolicy.decide_rung0``; not ported yet):

  * **stop value** — the reward of keeping the cached answer at $0:
    ``R(q_entry - gamma * sigma(d), 0)`` where ``sigma(d)`` is a
    distance-derived confidence spread (``conf_slope * d / radius`` —
    an exact hit has no spread, a hit at the radius edge is discounted
    like an answer the ensemble disagrees about).
  * **escalation value** — for each real rung, the optimistic reward at
    that rung's predicted cost, using the belief rows pinned when the
    *cached* answer was originally scored.

A stop serves the cached answer; an escalate falls through to the real
ladder (the request is scored and routed as if the cache missed).

Distances run through :func:`repro_torch.kernels.ops.pairwise_l2` (the
CUDA kernel on the card) on the scoring pass's shared ``q_emb`` — no
second embedding pass. The entry matrix is a fixed ``(cap, d)`` host
buffer with a mirror on the cache's device, written row by row as
entries land, so a kernel lookup copies only the query rows in and the
(rows, entries) distances out.

Admission is bounded: LRU eviction at ``cap`` entries plus a per-entry
quality floor (never cache an answer worth repeating only by accident).
Invalidation is driven by the online drift detector
(:class:`repro_torch.online.drift.DriftDetector` alarm hooks): under domain
shift a stale cache is a quality cliff, so an alarm either flushes the
cache or marks every entry stale for re-probing ("probe" mode — a stale
hit is never served, and the fresh outcome that replaces it re-arms the
region).

Everything is a pure function of admitted state + query embeddings (LRU
ticks use a deterministic counter, never wall time), so cached runs
replay byte-identically under the virtual clock.

The port of ``repro.serving.semcache``, with one deliberate difference:
the radius test compares d^2 with r^2 in float32, the precision d^2 is
computed in. The reference squares the radius in float64, so a query
exactly at the radius (d^2 = float32(r)^2 rounded to float32) was
refused.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops

INVALIDATION_MODES = ("probe", "flush")

# Below this many (bucketed) query x entry cells the batched lookup runs
# as one fused numpy expression (cached per-slot norms, same math as the
# admission-path dedup check): the kernel's per-call launch and copies
# dominate tiny problems. At-scale lookups (big caps / wide buckets) go
# through the kernel. The threshold and the bucketing are the reference's,
# so both packages take the same branch for the same lookup.
_KERNEL_MIN_CELLS = 1 << 15


@dataclasses.dataclass
class CacheEntry:
    """One cached answer keyed by the embedding of the query that made it."""

    emb: np.ndarray                    # (d,) fp32 query embedding
    output: np.ndarray                 # generated tokens served on a hit
    member_name: str                   # pool member that produced the answer
    quality: float                     # quality credited to the answer
    cost: float                        # $ the answer originally cost to make
    # Router belief rows of the originating query (cascade rung-0 inputs).
    s_pred: Optional[np.ndarray] = None
    s_std_pred: Optional[np.ndarray] = None
    c_pred: Optional[np.ndarray] = None
    stale: bool = False                # drift-invalidated; never served
    last_used: int = 0                 # LRU tick (deterministic counter)


class CacheVerdict:
    """Outcome of one rung-0 lookup (returned by :meth:`SemanticCache.decide`)."""

    __slots__ = ("serve", "entry", "dist", "sigma", "reason")

    def __init__(self, serve: bool, entry: Optional[CacheEntry],
                 dist: float, sigma: float, reason: str):
        self.serve = serve
        self.entry = entry
        self.dist = dist
        self.sigma = sigma
        self.reason = reason  # "hit" | "stale" | "fallthrough" | "miss"


def calibrate_radius(emb: np.ndarray, quantile: float = 0.05,
                     sample: int = 512,
                     device: Optional[DeviceLike] = None) -> float:
    """Serving radius from the reference corpus's own geometry.

    Takes the ``quantile`` of nearest-neighbor distances among (a
    deterministic prefix sample of) the reference embeddings: queries
    closer than most in-distribution neighbor pairs are near-duplicates.
    The sample's distances run on ``device`` (the CUDA card unless the
    caller names another).
    """
    device = resolve_device(device)
    emb = np.asarray(emb, np.float32)
    s = emb[: min(sample, len(emb))]
    if len(s) < 2:
        return 1e-6
    st = torch.tensor(s, device=device)
    d2 = kops.pairwise_l2(st, st).cpu().numpy().astype(np.float64)
    np.fill_diagonal(d2, np.inf)
    nn = np.sqrt(np.maximum(d2.min(axis=1), 0.0))
    nn = nn[np.isfinite(nn)]
    return float(max(np.quantile(nn, quantile), 1e-6))


class SemanticCache:
    """Embedding-keyed answer cache serving as cascade rung 0.

    ``policy`` (the cascade layer's ``CascadePolicy``) makes a hit
    a real stop-vs-escalate decision; without one the cache degrades to a
    radius threshold (the quality floor was enforced at admission).
    ``drift`` optionally attaches a detector the cache owns — its alarms
    invalidate via :meth:`on_drift_alarm`, which is also registered as an
    ``alarm_hooks`` callback so an adapter-owned detector can drive the
    same invalidation. Kernel lookups run on ``device`` (the CUDA card
    unless the caller names another).
    """

    def __init__(self, radius: float, cap: int = 256, *,
                 quality_floor: float = 0.25, conf_slope: float = 0.25,
                 invalidate: str = "probe", policy=None, drift=None,
                 query_bucket: int = 64,
                 device: Optional[DeviceLike] = None):
        self.device = resolve_device(device)
        if radius <= 0.0:
            raise ValueError("radius must be > 0")
        if cap < 1:
            raise ValueError("cap must be >= 1")
        if invalidate not in INVALIDATION_MODES:
            raise ValueError(
                f"invalidate must be one of {INVALIDATION_MODES}")
        self.radius = float(radius)
        self.cap = int(cap)
        self.quality_floor = float(quality_floor)
        self.conf_slope = float(conf_slope)
        self.invalidate = invalidate
        self.policy = policy
        self.drift = drift
        self.query_bucket = int(query_bucket)
        self._entries: List[CacheEntry] = []
        self._emb_buf: Optional[np.ndarray] = None  # fixed (cap, d) fp32
        self._emb_dev: Optional[torch.Tensor] = None  # its mirror on device
        self._used_buf = np.zeros(self.cap, np.int64)  # LRU ticks, slot-major
        self._norm_buf = np.zeros(self.cap, np.float32)  # ||emb||^2 per slot
        self._seq = 0                               # deterministic LRU tick
        self.stats = {
            "lookups": 0, "hits": 0, "misses": 0, "stale_hits": 0,
            "fallthroughs": 0, "served": 0, "admitted": 0, "refreshed": 0,
            "evicted": 0, "invalidations": 0, "flushes": 0,
        }
        if drift is not None:
            drift.alarm_hooks.append(self.on_drift_alarm)

    def __len__(self) -> int:
        return len(self._entries)

    # -- lookup ---------------------------------------------------------------

    def _tick(self) -> int:
        self._seq += 1
        return self._seq

    def match(self, q_emb: np.ndarray) -> List[Optional[Tuple[int, float]]]:
        """Nearest cached entry within radius per query row.

        Returns ``(entry_index, distance)`` per row, or ``None`` on a miss.
        Stale entries still match (the caller decides what a stale hit
        means); batched through pairwise_l2 against the device mirror of
        the live entries. Problems under ``_KERNEL_MIN_CELLS`` cells (the
        query count rounded up to ``query_bucket``, as the reference
        decides) short-circuit to a fused numpy norm expansion. The kernel
        takes the real rows only: with no jit to retrace, nothing is
        padded, and the real entries' distances are the same values.
        """
        q_emb = np.asarray(q_emb, np.float32)
        if q_emb.ndim == 1:
            q_emb = q_emb[None]
        b = q_emb.shape[0]
        n = len(self._entries)
        if n == 0 or b == 0:
            return [None] * b
        bucket = self.query_bucket
        b_pad = -(-b // bucket) * bucket
        if b_pad * n < _KERNEL_MIN_CELLS:
            d2 = (self._norm_buf[:n][None, :]
                  - 2.0 * (q_emb @ self._emb_buf[:n].T)
                  + np.einsum("ij,ij->i", q_emb, q_emb)[:, None])
        else:
            q = torch.tensor(q_emb, device=self.device)
            d2 = kops.pairwise_l2(q, self._emb_dev[:n]).cpu().numpy()
        nn = np.argmin(d2, axis=1)
        r2 = self._r2()
        out: List[Optional[Tuple[int, float]]] = []
        for i in range(b):
            j = int(nn[i])
            v = d2[i, j]
            out.append((j, math.sqrt(v) if v > 0.0 else 0.0)
                       if v <= r2 else None)
        return out

    def _r2(self) -> np.float32:
        """The squared radius in float32, the precision of every d^2."""
        r = np.float32(self.radius)
        return r * r

    def decide(self, hit: Optional[Tuple[int, float]], lam: float, *,
               headroom: float = 1.0) -> CacheVerdict:
        """Rung-0 stop-vs-escalate for one lookup result.

        A hit is a zero-marginal-cost leg whose quality confidence
        degrades with distance; with a cascade policy installed, serving
        it is exactly the policy's stop decision at ``cum_cost=0``.
        """
        self.stats["lookups"] += 1
        if hit is None:
            self.stats["misses"] += 1
            return CacheVerdict(False, None, float("inf"), 0.0, "miss")
        return self._decide_hit(hit, lam, headroom)

    def note_miss(self) -> None:
        """Account a lookup miss without building a verdict (hot path)."""
        self.stats["lookups"] += 1
        self.stats["misses"] += 1

    def _decide_hit(self, hit: Tuple[int, float], lam: float,
                    headroom: float) -> CacheVerdict:
        j, dist = hit
        entry = self._entries[j]
        if entry.stale:
            self.stats["stale_hits"] += 1
            return CacheVerdict(False, entry, dist, 0.0, "stale")
        sigma = self.conf_slope * dist / self.radius
        if self.policy is not None and entry.s_pred is not None:
            d = self.policy.decide_rung0(
                q_cache=entry.quality, sigma_cache=sigma,
                s_hat=entry.s_pred, s_std=entry.s_std_pred,
                c_hat=entry.c_pred, lam=lam, headroom=headroom)
            if d.escalate:
                self.stats["fallthroughs"] += 1
                return CacheVerdict(False, entry, dist, sigma, "fallthrough")
        self.stats["hits"] += 1
        self.stats["served"] += 1
        entry.last_used = self._tick()
        self._used_buf[j] = entry.last_used
        return CacheVerdict(True, entry, dist, sigma, "hit")

    def _nearest_np(self, emb: np.ndarray) -> Optional[Tuple[int, float]]:
        """Single-row nearest-within-radius in plain numpy.

        The admission-time duplicate check runs once per finalized
        request — off the batched lookup path, so it skips the kernel
        dispatch overhead pairwise_l2 amortizes over query batches."""
        n = len(self._entries)
        if n == 0:
            return None
        # ||x - e||^2 = ||x||^2 - 2 x.e + ||e||^2 with per-slot norms
        # cached at write time: one BLAS matvec instead of a full
        # (n, d) difference materialization per admission.
        d2 = (self._norm_buf[:n] - 2.0 * (self._emb_buf[:n] @ emb)
              + float(emb @ emb))
        j = int(np.argmin(d2))
        v = d2[j]
        if v > self._r2():
            return None
        return (j, math.sqrt(v) if v > 0.0 else 0.0)

    # -- admission / eviction -------------------------------------------------

    def admit(self, emb: np.ndarray, *, output, member_name: str,
              quality: float, cost: float, s_pred=None, s_std_pred=None,
              c_pred=None) -> bool:
        """Admit a served outcome; returns True when it entered the cache.

        An outcome within radius of an existing entry *refreshes* that
        entry in place (clearing any stale mark — this is how "probe"
        invalidation re-arms a region); otherwise LRU-evict at capacity.
        Quality below the floor (or non-finite) never enters.
        """
        quality = float(quality)
        if not np.isfinite(quality) or quality < self.quality_floor:
            return False
        emb = np.asarray(emb, np.float32).reshape(-1)
        entry = CacheEntry(
            emb=emb, output=np.asarray(output), member_name=str(member_name),
            quality=quality, cost=float(cost),
            s_pred=None if s_pred is None else np.asarray(s_pred, np.float64),
            s_std_pred=(None if s_std_pred is None
                        else np.asarray(s_std_pred, np.float64)),
            c_pred=None if c_pred is None else np.asarray(c_pred, np.float64),
            last_used=self._tick())
        if self._emb_buf is None:
            self._emb_buf = np.zeros((self.cap, emb.shape[0]), np.float32)
            self._emb_dev = torch.zeros((self.cap, emb.shape[0]),
                                        dtype=torch.float32, device=self.device)
        hit = self._nearest_np(emb)
        if hit is not None:
            slot = hit[0]
            self._entries[slot] = entry
            self._write_slot(slot, emb, entry.last_used)
            self.stats["refreshed"] += 1
            return True
        if len(self._entries) >= self.cap:
            slot = int(np.argmin(self._used_buf[: len(self._entries)]))
            self._entries[slot] = entry
            self._write_slot(slot, emb, entry.last_used)
            self.stats["evicted"] += 1
        else:
            self._entries.append(entry)
            self._write_slot(len(self._entries) - 1, emb, entry.last_used)
        self.stats["admitted"] += 1
        return True

    def _write_slot(self, slot: int, emb: np.ndarray, tick: int) -> None:
        self._emb_buf[slot] = emb
        self._emb_dev[slot] = torch.from_numpy(emb)
        self._used_buf[slot] = tick
        self._norm_buf[slot] = float(emb @ emb)

    # -- invalidation ---------------------------------------------------------

    def on_drift_alarm(self, now: float = 0.0) -> None:
        """Drift alarm: the query distribution moved, cached answers may be
        stale. "flush" drops everything; "probe" marks entries stale so
        they stop being served but their regions re-arm when a fresh
        outcome lands within radius."""
        n = len(self._entries)
        if n == 0:
            return
        self.stats["invalidations"] += n
        if self.invalidate == "flush":
            self._entries.clear()
            if self._emb_buf is not None:
                self._emb_buf[:] = 0.0
                self._emb_dev.zero_()
            self._used_buf[:] = 0
            self._norm_buf[:] = 0.0
            self.stats["flushes"] += 1
        else:
            for e in self._entries:
                e.stale = True

    def observe_queries(self, q_emb: np.ndarray, now: float = 0.0) -> bool:
        """Feed the scoring pass's embeddings to a cache-owned drift
        detector (no-op when invalidation rides an adapter's detector).
        The alarm hook registered at construction does the invalidation;
        refit re-anchors so the detector watches for the *next* shift."""
        if self.drift is None or self.drift.ref_mean is None:
            return False
        fired = self.drift.observe(q_emb, now)
        if fired:
            self.drift.refit()
        return fired

    def report(self) -> dict:
        out = dict(self.stats)
        out["entries"] = len(self._entries)
        out["stale_entries"] = sum(1 for e in self._entries if e.stale)
        out["radius"] = self.radius
        out["hit_rate"] = (self.stats["served"] / self.stats["lookups"]
                           if self.stats["lookups"] else 0.0)
        return out
