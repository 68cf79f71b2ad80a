"""The port's corpus, traffic and telemetry copies against the reference.

``routerbench.generate`` and ``make_trace`` are numpy-only copies and must
agree bit for bit. Telemetry's ``Histogram.percentile`` differs on
purpose at the ends: the port returns exactly ``min`` at p = 0 and exactly
``max`` at p = 100 (the property ``tests/test_telemetry_properties.py``
states), where the reference can land one ulp short of ``max``.
"""
import csv

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.data.routerbench import POOLS as JAX_POOLS
from repro.data.routerbench import generate as jax_generate
from repro.data.routerbench import load_csv as jax_load_csv
from repro.serving.budget import BudgetGovernor as JaxGovernor
from repro.serving.telemetry import Histogram as JaxHistogram
from repro.serving.traffic import TraceConfig as JaxTraceConfig
from repro.serving.traffic import make_trace as jax_make_trace
from repro_torch.data.routerbench import BENCHMARKS, MODELS, POOLS, generate, load_csv
from repro_torch.serving.budget import BudgetGovernor
from repro_torch.serving.queue import EXPIRED, REJECTED, AdmissionQueue, Request
from repro_torch.serving.telemetry import Histogram, Telemetry
from repro_torch.serving.traffic import TRACE_KINDS, TraceConfig, make_trace


def _assert_data_equal(got, want):
    assert got.texts == want.texts
    assert got.emb.dtype == want.emb.dtype
    for name in ("emb", "benchmark", "domain", "quality", "cost"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.model_names == want.model_names


@pytest.mark.parametrize("n,seed", [(60, 0), (150, 7)])
def test_generate_is_bit_identical(n, seed):
    got, want = generate(n, seed=seed), jax_generate(n, seed=seed)
    _assert_data_equal(got, want)
    for a, b in zip(got.split(seed=seed), want.split(seed=seed)):
        np.testing.assert_array_equal(a, b)
    assert set(got.benchmark) <= set(BENCHMARKS) and got.model_names == MODELS


@pytest.mark.parametrize("name", ["pool1", "pool2", "pool3", "pool4"])
def test_pools_and_subsets_match_reference(name):
    got, want = generate(60, seed=3), jax_generate(60, seed=3)
    assert POOLS == JAX_POOLS
    _assert_data_equal(got.pool(name), want.pool(name))
    mask = np.arange(60) % 3 == 1
    _assert_data_equal(got.pool(name).select(mask), want.pool(name).select(mask))
    assert got.pool(name).model_names == POOLS[name]


def test_load_csv_matches_reference(tmp_path):
    path = tmp_path / "rb.csv"
    rows = [("what is 2+2", "gsm8k", "gsm8k", "m1", 1.0, 0.01),
            ("what is 2+2", "gsm8k", "gsm8k", "m0", 0.0, 0.002),
            ("name a river", "mmlu", "world_history", "m0", 1.0, 0.001),
            ("name a river", "mmlu", "world_history", "m1", 1.0, 0.02),
            ("only one model", "rag", "rag", "m0", 0.5, 0.003)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["prompt", "benchmark", "domain", "model", "quality", "cost"])
        w.writerows(rows)
    got, want = load_csv(str(path)), jax_load_csv(str(path))
    _assert_data_equal(got, want)
    assert len(got.texts) == 2       # the prompt missing m1 is dropped


@pytest.mark.parametrize("kind", TRACE_KINDS)
def test_make_trace_is_bit_identical(kind):
    data = generate(80, seed=2)
    texts, bench = data.texts, list(data.benchmark)
    kw = dict(kind=kind, n_requests=64, rate=300.0, seed=5, max_new=3,
              deadline_s=0.4, vocab=97, hot_set=8)
    got = make_trace(TraceConfig(**kw), texts, bench)
    want = jax_make_trace(JaxTraceConfig(**kw), texts, bench)
    assert len(got) == len(want) == 64
    for g, w in zip(got, want):
        assert (g.text, g.max_new, g.arrival_s, g.deadline_s) == \
            (w.text, w.max_new, w.arrival_s, w.deadline_s)
        assert g.prompt.dtype == w.prompt.dtype
        np.testing.assert_array_equal(g.prompt, w.prompt)


# The reference's percentile(100) on these values is 4.7439999999999996e-07,
# one ulp short of max 4.744e-07 (log interpolation).
ULP_SHORT = [4.744e-07, 1.566e-07, 2.122e-07]


def _hist(cls, values):
    h = cls()
    for v in values:
        h.record(float(v))
    return h


def test_percentile_ends_are_exact_where_reference_is_an_ulp_short():
    ref = _hist(JaxHistogram, ULP_SHORT)
    assert ref.percentile(100) < ref.max       # the reference's fault, pinned
    h = _hist(Histogram, ULP_SHORT)
    assert h.percentile(100) == h.max == 4.744e-07
    assert h.percentile(0) == h.min == 1.566e-07


@given(st.lists(st.floats(1e-9, 5e-7), min_size=1, max_size=40))
@settings(max_examples=40, deadline=None)
def test_percentile_underflow_monotone_with_exact_ends(values):
    h = _hist(Histogram, values)
    ests = [h.percentile(p) for p in range(0, 101, 10)]
    assert all(a <= b + 1e-20 for a, b in zip(ests, ests[1:]))
    assert ests[0] == h.min and ests[-1] == h.max


@given(st.lists(st.floats(1e-7, 1e4), min_size=1, max_size=30))
@settings(max_examples=40, deadline=None)
def test_percentile_interior_matches_reference(values):
    h, ref = _hist(Histogram, values), _hist(JaxHistogram, values)
    for p in (1, 25, 50, 90, 99):
        assert h.percentile(p) == ref.percentile(p)


def test_queue_backpressure_and_expiry():
    q = AdmissionQueue(capacity=2)
    reqs = [Request(text=str(i), prompt=np.zeros(2, np.int32), deadline_s=0.1 * (i + 1))
            for i in range(3)]
    assert [q.offer(r, 0.0) for r in reqs] == [True, True, False]
    assert reqs[2].status == REJECTED and q.rejected == 1
    dropped = q.expire(0.15)
    assert dropped == [reqs[0]] and reqs[0].status == EXPIRED and q.depth == 1


def test_budget_governor_matches_reference():
    got, want = BudgetGovernor(0.01, 0.5, lam0=2.0), JaxGovernor(0.01, 0.5, lam0=2.0)
    rng = np.random.default_rng(0)
    for t in np.linspace(0.0, 3.0, 40):
        cost = float(rng.uniform(0, 0.004))
        got.record(cost, t)
        want.record(cost, t)
        assert got.update(t) == want.update(t)
    assert got.summary(3.0) == want.summary(3.0)


def test_telemetry_report_counts_cache_outcomes():
    t = Telemetry(["a", "b"])
    for outcome in ("hit", "miss", "stale", "hit"):
        t.record_cache(outcome)
    s = t.summary()
    assert (s["cache_hits"], s["cache_misses"], s["cache_stale"]) == (2, 1, 1)
    assert s["cache_hit_rate"] == 0.5
