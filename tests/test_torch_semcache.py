"""The port's semantic cache: the reference's unit properties, and parity.

The units of tests/test_semcache.py (quality floor, refresh, LRU, cap,
radius monotonicity, probe/flush invalidation, cache-owned drift detector)
run on the port with ``device="cpu"``. The radius boundary is held to the
property the reference's test states (x <= r is served, x > r + 1e-6 is
not), which the port meets by comparing d^2 with r^2 in float32.

``match`` and ``calibrate_radius`` are compared with the reference's on
both of ``match``'s branches: the fused numpy expression (small caches) and
``pairwise_l2`` (64 queries against 512 entries, 32768 cells). Squared
distances agree within 1e-4 (the square root of a rounding error near an
exact repeat's d^2 = 0 is ~1e-3, so distances are compared squared); a
query whose d^2 lies within 1e-4 of r^2 may hit on one side and miss on
the other (the two sum in other orders), so that band is excluded from
the hit comparison and must stay small.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.serving.semcache import SemanticCache as JaxCache
from repro.serving.semcache import calibrate_radius as jax_calibrate_radius
from repro_torch.data.routerbench import generate
from repro_torch.online.drift import DriftDetector
from repro_torch.serving.semcache import _KERNEL_MIN_CELLS, SemanticCache, calibrate_radius

D = 8


def emb_at(x: float, d: int = D) -> np.ndarray:
    e = np.zeros(d, np.float32)
    e[0] = x
    return e


def admit(cache, x, quality=1.0, cost=1.0):
    return cache.admit(emb_at(x), output=np.arange(4, dtype=np.int32),
                       member_name="m0", quality=quality, cost=cost)


def cache(radius, **kw):
    return SemanticCache(radius, device="cpu", **kw)


class TestAdmissionEviction:
    def test_quality_floor_rejects(self):
        c = cache(0.5, cap=4, quality_floor=0.25)
        assert not admit(c, 0.0, quality=0.1)
        assert not admit(c, 0.0, quality=float("nan"))
        assert len(c) == 0
        assert admit(c, 0.0, quality=0.3)
        assert len(c) == 1

    def test_within_radius_refreshes_not_appends(self):
        c = cache(0.5, cap=4)
        admit(c, 0.0, quality=0.5)
        admit(c, 0.1, quality=0.9)
        assert len(c) == 1 and c.stats["refreshed"] == 1
        hit = c.match(emb_at(0.05))[0]
        assert hit is not None and c._entries[hit[0]].quality == 0.9

    def test_lru_evicts_least_recently_used(self):
        c = cache(0.4, cap=2)
        admit(c, 0.0)
        admit(c, 10.0)
        assert c.decide(c.match(emb_at(0.0))[0], lam=10.0).serve
        admit(c, 20.0)
        assert len(c) == 2 and c.stats["evicted"] == 1
        assert c.match(emb_at(0.0))[0] is not None
        assert c.match(emb_at(10.0))[0] is None
        assert c.match(emb_at(20.0))[0] is not None

    @settings(max_examples=32, deadline=None)
    @given(st.integers(1, 8), st.integers(1, 40))
    def test_cap_never_exceeded(self, cap, n):
        c = cache(1e-3, cap=cap)
        for i in range(n):
            admit(c, float(i))
            assert len(c) <= cap
        assert c.stats["admitted"] == n
        assert c.stats["evicted"] == max(0, n - cap)

    @settings(max_examples=32, deadline=None)
    @given(st.floats(0.05, 1.0), st.floats(1.05, 3.0), st.floats(0.0, 3.0))
    def test_radius_serve_monotone(self, r1, scale, x):
        small, big = cache(r1, cap=4), cache(r1 * scale, cap=4)
        admit(small, 0.0)
        admit(big, 0.0)
        v_small = small.decide(small.match(emb_at(x))[0], lam=10.0)
        v_big = big.decide(big.match(emb_at(x))[0], lam=10.0)
        if v_small.serve:
            assert v_big.serve
        assert v_small.serve == (x <= r1 + 1e-6)

    @settings(max_examples=48, deadline=None)
    @given(st.floats(0.05, 3.0), st.floats(0.0, 1.0))
    def test_radius_boundary(self, r, frac):
        """x <= r is served, x > r + 1e-6 is not, on the match path and on
        the admission-time refresh check alike."""
        c = cache(r, cap=4)
        admit(c, 0.0)
        inside, outside = r * frac, r + 1e-6 + frac
        assert c.match(emb_at(inside))[0] is not None
        assert c.match(emb_at(r))[0] is not None
        assert c.match(emb_at(outside))[0] is None
        assert c._nearest_np(emb_at(r)) is not None
        assert c._nearest_np(emb_at(outside)) is None

    def test_query_exactly_at_radius_is_served(self):
        """The reference refuses it: float32(0.05)^2 rounds to
        0.0025000000745 > 0.05 * 0.05 in float64."""
        ref = JaxCache(0.05, cap=4)
        ref.admit(emb_at(0.0), output=np.arange(4), member_name="m0",
                  quality=1.0, cost=1.0)
        assert ref.match(emb_at(0.05))[0] is None
        c = cache(0.05, cap=4)
        admit(c, 0.0)
        hit = c.match(emb_at(0.05))[0]
        assert hit is not None and hit[0] == 0
        assert hit[1] == pytest.approx(0.05, rel=1e-7)

    def test_calibrate_radius_on_clustered_corpus(self):
        emb = np.random.default_rng(0).standard_normal((200, D)).astype(np.float32)
        r = calibrate_radius(emb, device="cpu")
        d2 = ((emb[None] - emb[:, None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        assert r > 0 and np.mean(np.sqrt(d2.min(axis=1)) >= r) > 0.8


class TestDriftInvalidation:
    def test_probe_marks_stale_and_fresh_admission_rearms(self):
        c = cache(0.5, cap=4, invalidate="probe")
        admit(c, 0.0, quality=0.9)
        c.on_drift_alarm()
        v = c.decide(c.match(emb_at(0.0))[0], lam=10.0)
        assert not v.serve and v.reason == "stale"
        assert c.stats["stale_hits"] == 1
        admit(c, 0.1, quality=0.8)
        v2 = c.decide(c.match(emb_at(0.0))[0], lam=10.0)
        assert v2.serve and v2.entry.quality == 0.8

    def test_flush_drops_everything_and_zeroes_the_device_mirror(self):
        c = cache(0.5, cap=4, invalidate="flush")
        admit(c, 0.0)
        admit(c, 10.0)
        assert torch.equal(c._emb_dev, torch.from_numpy(c._emb_buf))
        c.on_drift_alarm()
        assert len(c) == 0 and c.stats["flushes"] == 1
        assert c.match(emb_at(0.0))[0] is None
        assert not c._emb_dev.any() and not c._emb_buf.any()

    def test_cache_owned_detector_fires_hook(self):
        ref = np.random.default_rng(0).standard_normal((128, D)).astype(np.float32)
        det = DriftDetector(window=16, patience=1, device="cpu").fit(ref)
        c = cache(0.5, cap=4, drift=det)
        admit(c, 0.0)
        c.observe_queries(ref[:32] + 25.0, now=1.0)
        assert c.stats["invalidations"] >= 1


def _corpus(n=700, seed=11):
    return generate(n, seed=seed).emb          # float64, as the featurizer gives


def _fill(port, ref, emb, qualities):
    for i, (e, q) in enumerate(zip(emb, qualities)):
        kw = dict(output=np.arange(3, dtype=np.int32) + i, member_name=f"m{i % 2}",
                  quality=float(q), cost=0.001 * i)
        assert port.admit(e, **kw) == ref.admit(e, **kw)
    assert port.stats == ref.stats and len(port) == len(ref)


def _queries(entries, n, rng):
    """Half exact repeats of cached entries, a quarter near them, a quarter
    fresh rows of another corpus."""
    rep = entries[rng.choice(len(entries), n // 2, replace=False)]
    near = entries[rng.choice(len(entries), n // 4, replace=False)]
    near = near + rng.standard_normal(near.shape).astype(np.float32) * 0.01
    return np.concatenate([rep, near, _corpus(n - n // 2 - n // 4, seed=99)])


@pytest.mark.parametrize("cap,n_admit,n_query", [(8, 8, 4), (64, 40, 16),
                                                 (512, 700, 64)])
def test_match_agrees_with_reference(cap, n_admit, n_query):
    corpus = _corpus()
    radius = calibrate_radius(corpus[:400], device="cpu")
    port = SemanticCache(radius, cap=cap, device="cpu")
    ref = JaxCache(radius, cap=cap)
    rng = np.random.default_rng(cap)
    _fill(port, ref, corpus[:n_admit], rng.uniform(0.3, 1.0, n_admit))
    n = len(port)
    kernel_branch = -(-n_query // 64) * 64 * n >= _KERNEL_MIN_CELLS
    assert kernel_branch == (cap == 512), "the sweep covers both branches"
    q = _queries(port._emb_buf[:n].copy(), n_query, rng)
    got, want = port.match(q), ref.match(q)
    d2 = ((q[:, None, :].astype(np.float64) - port._emb_buf[None, :n]) ** 2).sum(-1)
    near_r2 = np.abs(d2.min(axis=1) - np.float32(radius) ** 2) < 1e-4
    assert near_r2.sum() <= n_query // 8
    n_hits = 0
    for g, w, skip in zip(got, want, near_r2):
        if skip:
            continue
        assert (g is None) == (w is None)
        if g is not None:
            n_hits += 1
            assert g[0] == w[0]
            assert g[1] ** 2 == pytest.approx(w[1] ** 2, abs=1e-4)
    assert n_hits >= n_query // 2            # the exact repeats hit at least


def test_calibrate_radius_agrees_with_reference():
    emb = _corpus(600, seed=5)
    got = calibrate_radius(emb, device="cpu")
    want = jax_calibrate_radius(emb)
    assert got == pytest.approx(want, rel=1e-4)
