"""The port's drift detector: the reference's pins, and parity at 768-d.

The regression pins of tests/test_drift_regression.py hold on the port
with ``device="cpu"``: the bootstrap null within rtol 1e-5 of the pinned
values (the null's inputs are fp32 distances, summed in another order than
the reference's), the first alarm at window 7, four alarms, and recovery
after refit. The bootstrap's window picks come from the same seeded numpy
generator as the reference's, so on 768-d corpus embeddings with 20
k-means centroids the port's and the reference's detectors agree on every
window's statistics within 1e-5, and on each alarm wherever the window's
z-scores lie at least 1e-3 from the threshold.
"""
import numpy as np
import pytest

from repro.core.clustering import kmeans as jax_kmeans
from repro.online.drift import DriftDetector as JaxDetector
from repro_torch.data.routerbench import generate
from repro_torch.online.drift import DriftDetector
from test_drift_regression import (
    PINNED_FIRST_ALARM_WINDOW,
    PINNED_NULL_DISPERSION,
    PINNED_NULL_SHIFT,
    PINNED_TOTAL_ALARMS,
    _emb,
)


def _fit_detector():
    ref = _emb(np.random.default_rng(42), 300)
    return DriftDetector(window=32, threshold=3.0, patience=2, n_bootstrap=64,
                         seed=5, device="cpu").fit(ref)


def _run_trace():
    det = _fit_detector()
    rng = np.random.default_rng(7)
    fired = [bool(det.observe(_emb(rng, 32, 1.0 if i < 6 else -1.0), now=float(i)))
             for i in range(14)]
    return det, fired


def test_null_matches_pinned_regression_values():
    det = _fit_detector()
    np.testing.assert_allclose(det.null_shift, PINNED_NULL_SHIFT, rtol=1e-5)
    np.testing.assert_allclose(det.null_dispersion, PINNED_NULL_DISPERSION, rtol=1e-5)
    assert det.null_shift[1] > 0 and det.null_dispersion[1] > 0


def test_fixed_seed_fit_is_bitwise_reproducible():
    d1, d2 = _fit_detector(), _fit_detector()
    assert d1.null_shift == d2.null_shift
    assert d1.null_dispersion == d2.null_dispersion


def test_first_alarm_and_total_count_pinned():
    det, fired = _run_trace()
    assert fired.index(True) == PINNED_FIRST_ALARM_WINDOW
    assert det.alarms == PINNED_TOTAL_ALARMS
    assert not any(fired[:6])


def test_trace_replays_identically_and_refit_recovers():
    (d1, f1), (d2, f2) = _run_trace(), _run_trace()
    assert f1 == f2 and d1.last_stats == d2.last_stats
    d1.refit()
    assert not d1.observe(_emb(np.random.default_rng(13), 128, -1.0))


def test_refit_keeps_the_centroids_on_the_device():
    det = _fit_detector()
    before = det._centroids_dev
    det.observe(_emb(np.random.default_rng(1), 40, -1.0))
    det.refit()
    assert det._centroids_dev is before


@pytest.fixture(scope="module")
def corpus():
    data = generate(500, seed=3)
    tr, _, te = data.split(seed=3)
    centroids, _ = jax_kmeans(data.emb[tr], 20, seed=0)
    return data, tr, te, centroids


@pytest.mark.parametrize("window,patience", [(8, 1), (48, 2)])
def test_detector_agrees_with_reference_at_768(corpus, window, patience):
    data, tr, te, centroids = corpus
    kw = dict(window=window, threshold=4.0, patience=patience, seed=0)
    port = DriftDetector(device="cpu", **kw).fit(data.emb[tr], centroids)
    ref = JaxDetector(**kw).fit(data.emb[tr], centroids)
    np.testing.assert_allclose(port.null_shift, ref.null_shift, rtol=1e-5)
    np.testing.assert_allclose(port.null_dispersion, ref.null_dispersion, rtol=1e-5)
    # In-distribution held-out rows, then a shifted regime.
    rng = np.random.default_rng(window)
    held = data.emb[te]
    stream = [held[rng.choice(len(held), window)] for _ in range(4)]
    stream += [held[rng.choice(len(held), window)] * 0.6 + 0.05 for _ in range(4)]
    decided = 0
    for i, batch in enumerate(stream):
        got, want = port.observe(batch, now=float(i)), ref.observe(batch, now=float(i))
        for key in ("mean_shift", "dispersion", "shift_z", "dispersion_z"):
            assert port.last_stats[key] == pytest.approx(ref.last_stats[key],
                                                         rel=1e-5, abs=1e-5)
        z = (ref.last_stats["shift_z"], abs(ref.last_stats["dispersion_z"]))
        if all(abs(v - kw["threshold"]) >= 1e-3 for v in z):
            assert got == want
            decided += 1
    assert decided >= 6
    assert port.windows_seen == ref.windows_seen == 8
    assert ref.alarms > 0, "the shifted regime must raise an alarm"
