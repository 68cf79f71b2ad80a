"""Query-distribution drift detection over embedding population statistics.

The detector is fit on a reference sample of query embeddings (typically
the router's offline training split) and then watches the live stream in
fixed-size windows. Two statistics per window:

  * **mean shift** — L2 distance between the window mean embedding and the
    reference mean;
  * **dispersion** — mean distance-to-nearest-centroid, computed with
    :func:`repro_torch.kernels.ops.pairwise_l2` (the CUDA kernel on the
    card) against the k-means centroids that also back the model
    embeddings (batched distance-to-centroid is exactly that kernel's
    shape).

Both statistics are calibrated against a **bootstrap null**: ``fit``
resamples same-sized windows from the reference and records the null mean
and spread of each statistic. This matters in high dimension — the
expected shift of an in-distribution window is ``~sigma/sqrt(n)`` but its
*spread* around that expectation is far tighter, so an analytic
``sigma/sqrt(n)`` threshold would need the drifted mean to move further
than real embedding drift ever does. Alarms compare z-scores under the
empirical null instead.

``patience`` consecutive abnormal windows raise one alarm (then the
counter re-arms), so a single weird batch doesn't trigger an update burst
but a sustained excursion does. :meth:`refit` re-anchors the reference —
the adapter calls it after an adaptation burst so the detector "recovers"
and watches for the *next* shift instead of alarming forever.

The port of ``repro.online.drift``. Distances run on ``device`` (the CUDA
card unless the caller names another): the centroids move there once, at
:meth:`DriftDetector.fit`, and each distance call copies only the query
rows in and the (rows, C) result out. The bootstrap keeps the reference's
seeded numpy generator, so its window picks are the reference's bit for
bit and only the distances differ, within fp32 tolerance.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops


class DriftDetector:
    def __init__(self, *, window: int = 64, threshold: float = 4.0,
                 patience: int = 2, n_bootstrap: int = 64, seed: int = 0,
                 device: Optional[DeviceLike] = None):
        if window < 2:
            raise ValueError("window must be >= 2")
        self.device = resolve_device(device)
        self.window = window
        self.threshold = threshold          # z-score under the bootstrap null
        self.patience = patience
        self.n_bootstrap = n_bootstrap
        self._boot_rng = np.random.default_rng(seed)

        self.ref_mean: Optional[np.ndarray] = None
        # Bootstrap null (mean, std) of each window statistic.
        self.null_shift = (0.0, 1.0)
        self.null_dispersion = (0.0, 1.0)
        self.centroids: Optional[np.ndarray] = None
        self._centroids_dev: Optional[torch.Tensor] = None   # on self.device

        self._buf: List[np.ndarray] = []
        self._last_window: Optional[np.ndarray] = None
        self._abnormal_streak = 0
        self.alarms = 0
        self.windows_seen = 0
        self.last_stats: Dict[str, float] = {}
        # Alarm fan-out: callables invoked with the alarm time whenever an
        # alarm fires, regardless of which caller fed observe(). The
        # semantic cache registers its invalidation here so one detector
        # (the adapter's or its own) drives both adaptation and cache
        # invalidation without the callers coordinating.
        self.alarm_hooks: List = []

    @property
    def abnormal_streak(self) -> int:
        """Consecutive abnormal windows so far (alarm fires at patience).

        Public alarm-state readout for the metrics registry: 0 = nominal,
        >= 1 = an excursion is building toward an alarm.
        """
        return self._abnormal_streak

    # -- reference -----------------------------------------------------------

    def _sq_dists(self, emb: np.ndarray) -> np.ndarray:
        """(n, C) squared distances to the centroids, through pairwise_l2."""
        q = torch.tensor(np.asarray(emb, np.float32), device=self.device)
        return kops.pairwise_l2(q, self._centroids_dev).cpu().numpy()

    def _dispersion(self, emb: np.ndarray) -> float:
        """Mean distance to the nearest centroid."""
        d2 = self._sq_dists(emb)
        return float(np.sqrt(np.maximum(d2.min(axis=1), 0.0)).mean())

    def fit(self, ref_emb: np.ndarray,
            centroids: Optional[np.ndarray] = None) -> "DriftDetector":
        ref_emb = np.asarray(ref_emb, np.float32)
        self.ref_mean = ref_emb.mean(axis=0)
        cents = (np.asarray(centroids, np.float32)
                 if centroids is not None else self.ref_mean[None])
        if cents is not self.centroids:   # refit keeps the centroids in place
            self.centroids = cents
            self._centroids_dev = torch.tensor(cents, device=self.device)
        # Bootstrap null: statistics of in-distribution windows of the
        # deployed size. Window picks use a detector-owned seeded rng, so
        # fit/refit is deterministic.
        n = len(ref_emb)
        size = min(self.window, n)
        shifts, disps = [], []
        # All per-point distances once; window dispersion = mean over picks.
        d_point = np.sqrt(np.maximum(self._sq_dists(ref_emb).min(axis=1), 0.0))
        for _ in range(self.n_bootstrap):
            idx = self._boot_rng.integers(n, size=size)
            shifts.append(float(np.linalg.norm(
                ref_emb[idx].mean(axis=0) - self.ref_mean)))
            disps.append(float(d_point[idx].mean()))
        # Bootstrap windows measure shift against the ref mean of the SAME
        # sample, so they miss the ref mean's own error: an independent
        # window shifts by ~sigma*sqrt(1/size + 1/n), not sigma/sqrt(size).
        # Matters after refit(), when the reference is a single window.
        infl = float(np.sqrt(1.0 + size / max(n, 1)))
        self.null_shift = (float(np.mean(shifts)) * infl,
                           float(np.std(shifts)) * infl + 1e-12)
        self.null_dispersion = (float(np.mean(disps)),
                                float(np.std(disps)) * infl + 1e-12)
        return self

    def refit(self, emb: Optional[np.ndarray] = None) -> None:
        """Re-anchor the reference to the current regime (recovery).

        With no argument, uses the last completed window (the sample that
        raised the alarm — i.e. the post-shift regime) plus any buffered
        stragglers.
        """
        if emb is None:
            parts = ([self._last_window] if self._last_window is not None
                     else [])
            if self._buf:
                parts.append(np.stack(self._buf))
            if not parts:
                return
            emb = np.concatenate(parts, axis=0)
        self._buf.clear()
        self._abnormal_streak = 0
        self.fit(emb, self.centroids)

    # -- stream --------------------------------------------------------------

    def observe(self, q_emb: np.ndarray, now: float = 0.0) -> bool:
        """Feed a batch of query embeddings; True when an alarm fires."""
        if self.ref_mean is None:
            raise RuntimeError("DriftDetector.observe before fit()")
        q_emb = np.asarray(q_emb, np.float32)
        if q_emb.ndim == 1:
            q_emb = q_emb[None]
        self._buf.extend(q_emb)
        fired = False
        while len(self._buf) >= self.window:
            win = np.stack(self._buf[: self.window])
            del self._buf[: self.window]
            fired |= self._check_window(win, now)
        return fired

    def _check_window(self, win: np.ndarray, now: float) -> bool:
        self.windows_seen += 1
        self._last_window = win
        shift = float(np.linalg.norm(win.mean(axis=0) - self.ref_mean))
        dispersion = self._dispersion(win)
        shift_z = (shift - self.null_shift[0]) / self.null_shift[1]
        disp_z = ((dispersion - self.null_dispersion[0])
                  / self.null_dispersion[1])
        self.last_stats = {
            "now": now,
            "mean_shift": shift,
            "shift_z": shift_z,
            "dispersion": dispersion,
            "dispersion_z": disp_z,
        }
        abnormal = (shift_z > self.threshold
                    or abs(disp_z) > self.threshold)
        if not abnormal:
            self._abnormal_streak = 0
            return False
        self._abnormal_streak += 1
        if self._abnormal_streak >= self.patience:
            self._abnormal_streak = 0
            self.alarms += 1
            for hook in self.alarm_hooks:
                hook(now)
            return True
        return False
