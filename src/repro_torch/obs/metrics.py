"""Exportable metrics registry: counters, gauges, histograms.

The port's copy of ``repro.obs.metrics``, pure Python: the same events, series
and bytes as the reference's for the same inputs.

Every serving subsystem registers its live state here — queue depth, router
swap versions, drift alarm state, exploration epsilon, budget-ledger
headroom, escalation rate by cascade rung — and two exporters read the
registry: Prometheus text exposition and a canonical JSON snapshot.

Two registration styles:

  * **owned** metrics hold their own value (``Counter.inc`` /
    ``Gauge.set`` / ``HistogramMetric.observe``);
  * **callback** metrics wrap a ``fn`` evaluated at export time — the
    preferred style for serving wiring (see :mod:`repro_torch.obs.wiring`),
    because it costs the hot path nothing: the scheduler keeps mutating
    its native counters and the registry reads them only when scraped.

Histograms reuse the serving runtime's log-bucketed
:class:`repro_torch.serving.telemetry.Histogram` (O(buckets) memory at any
traffic volume); the Prometheus exporter emits its buckets as cumulative
``_bucket{le=...}`` samples.

``wall=True`` marks metrics whose values derive from wall-clock
measurement (routing latency, kernel timings). ``snapshot(deterministic=
True)`` excludes them, so a seeded run's deterministic snapshot is
bit-identical across replays — the same contract as the trace export.
"""
from __future__ import annotations

import json
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.telemetry import Histogram


def _norm_labels(labels) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    if isinstance(labels, dict):
        labels = labels.items()
    return tuple(sorted((str(k), str(v)) for k, v in labels))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def _finite(x):
    """JSON-safe number (non-finite -> None)."""
    x = float(x)
    return x if math.isfinite(x) else None


class Metric:
    """Base: a named series with fixed labels."""

    mtype = "untyped"

    def __init__(self, name: str, help: str = "", labels=(),
                 wall: bool = False):
        self.name = name
        self.help = help
        self.labels = _norm_labels(labels)
        self.wall = wall

    @property
    def key(self) -> str:
        return self.name + _label_str(self.labels)


class Counter(Metric):
    mtype = "counter"

    def __init__(self, name, help="", labels=(), fn=None, wall=False):
        super().__init__(name, help, labels, wall)
        self.fn = fn
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if self.fn is not None:
            raise TypeError(f"counter {self.name} is callback-backed")
        self.value += v

    def read(self) -> float:
        return float(self.fn()) if self.fn is not None else self.value


class Gauge(Metric):
    mtype = "gauge"

    def __init__(self, name, help="", labels=(), fn=None, wall=False):
        super().__init__(name, help, labels, wall)
        self.fn = fn
        self.value = float("nan")

    def set(self, v: float) -> None:
        if self.fn is not None:
            raise TypeError(f"gauge {self.name} is callback-backed")
        self.value = float(v)

    def read(self) -> float:
        return float(self.fn()) if self.fn is not None else self.value


class MultiGauge(Metric):
    """A gauge family over one dynamic label (e.g. escalation rate by
    cascade rung, whose rung count grows during the run). ``fn()`` returns
    ``{label_value: number}`` at export time."""

    mtype = "gauge"

    def __init__(self, name, help, label_name: str,
                 fn: Callable[[], Dict], labels=(), wall=False):
        super().__init__(name, help, labels, wall)
        self.label_name = label_name
        self.fn = fn

    def read(self) -> Dict[str, float]:
        return {str(k): float(v) for k, v in self.fn().items()}


class HistogramMetric(Metric):
    """Wraps a log-bucketed :class:`Histogram` (owned or callback)."""

    mtype = "histogram"

    def __init__(self, name, help="", labels=(), hist: Optional[Histogram]
                 = None, fn=None, wall=False):
        super().__init__(name, help, labels, wall)
        if hist is not None and fn is not None:
            raise ValueError("pass hist or fn, not both")
        self.fn = fn
        self.hist = hist if hist is not None or fn is not None else Histogram()

    def observe(self, v: float) -> None:
        if self.fn is not None:
            raise TypeError(f"histogram {self.name} is callback-backed")
        self.hist.record(v)

    def resolve(self) -> Histogram:
        return self.fn() if self.fn is not None else self.hist


class MetricsRegistry:
    """All metrics of one run; exporters read it, subsystems register."""

    def __init__(self):
        self._metrics: List[Metric] = []
        self._keys = set()

    def register(self, metric: Metric) -> Metric:
        if metric.key in self._keys:
            raise ValueError(f"duplicate metric {metric.key}")
        self._keys.add(metric.key)
        self._metrics.append(metric)
        return metric

    # -- convenience constructors -------------------------------------------

    def counter(self, name, help="", labels=(), fn=None,
                wall=False) -> Counter:
        return self.register(Counter(name, help, labels, fn, wall))

    def gauge(self, name, help="", labels=(), fn=None, wall=False) -> Gauge:
        return self.register(Gauge(name, help, labels, fn, wall))

    def histogram(self, name, help="", labels=(), hist=None, fn=None,
                  wall=False) -> HistogramMetric:
        return self.register(
            HistogramMetric(name, help, labels, hist, fn, wall))

    def multi_gauge(self, name, help, label_name, fn, labels=(),
                    wall=False) -> MultiGauge:
        return self.register(
            MultiGauge(name, help, label_name, fn, labels, wall))

    def __len__(self) -> int:
        return len(self._metrics)

    # -- exporters -----------------------------------------------------------

    def snapshot(self, deterministic: bool = False) -> Dict:
        """JSON-safe snapshot: ``{series_key: {type, value|summary}}``.

        ``deterministic=True`` excludes wall-clock-backed metrics so the
        snapshot of a seeded run is replay-stable.
        """
        out: Dict[str, Dict] = {}
        for m in self._metrics:
            if deterministic and m.wall:
                continue
            if isinstance(m, MultiGauge):
                for lv, v in sorted(m.read().items()):
                    labels = m.labels + ((m.label_name, lv),)
                    out[m.name + _label_str(labels)] = {
                        "type": m.mtype, "value": _finite(v)}
            elif isinstance(m, HistogramMetric):
                h = m.resolve()
                out[m.key] = {
                    "type": m.mtype, "count": int(h.count),
                    "sum": _finite(h.total), "min": _finite(h.min),
                    "max": _finite(h.max), "mean": _finite(h.mean),
                    "p50": _finite(h.percentile(50)),
                    "p99": _finite(h.percentile(99)),
                }
            else:
                out[m.key] = {"type": m.mtype, "value": _finite(m.read())}
        return out

    def to_json(self, deterministic: bool = False) -> str:
        return json.dumps(self.snapshot(deterministic=deterministic),
                          sort_keys=True, separators=(",", ":"))

    def save(self, path: str, deterministic: bool = False) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(deterministic=deterministic))

    def prometheus(self, deterministic: bool = False) -> str:
        """Prometheus text exposition format (one scrape of the registry).

        ``deterministic=True`` skips wall-clock metrics, mirroring
        :meth:`snapshot` — streaming segment scrapes use it so the whole
        obs directory stays byte-identical across seeded replays."""
        lines: List[str] = []
        seen_names = set()
        for m in self._metrics:
            if deterministic and m.wall:
                continue
            if m.name not in seen_names:
                seen_names.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.mtype}")
            if isinstance(m, MultiGauge):
                for lv, v in sorted(m.read().items()):
                    labels = m.labels + ((m.label_name, lv),)
                    lines.append(f"{m.name}{_label_str(labels)} {v:g}")
            elif isinstance(m, HistogramMetric):
                h = m.resolve()
                # OpenMetrics-style exemplars: the histogram keeps one
                # deterministically min-hash-sampled trace key per raw
                # bucket; bucket line j carries raw bucket j's exemplar
                # and +Inf carries the overflow bucket's.
                ex = getattr(h, "exemplars", None) or {}
                cum = 0
                for j, edge in enumerate(h.edges):
                    cum = int(h.counts[: j + 1].sum())
                    labels = m.labels + (("le", f"{edge:g}"),)
                    line = f"{m.name}_bucket{_label_str(labels)} {cum}"
                    e = ex.get(j)
                    if e is not None:
                        line += f' # {{trace_key="{e[1]}"}} {e[2]:g}'
                    lines.append(line)
                labels = m.labels + (("le", "+Inf"),)
                line = (f"{m.name}_bucket{_label_str(labels)} "
                        f"{int(h.count)}")
                e = ex.get(len(h.edges))
                if e is not None:
                    line += f' # {{trace_key="{e[1]}"}} {e[2]:g}'
                lines.append(line)
                lines.append(f"{m.name}_sum{_label_str(m.labels)} "
                             f"{h.total:g}")
                lines.append(f"{m.name}_count{_label_str(m.labels)} "
                             f"{int(h.count)}")
            else:
                v = m.read()
                lines.append(f"{m.name}{_label_str(m.labels)} "
                             f"{v:g}" if math.isfinite(v)
                             else f"{m.name}{_label_str(m.labels)} NaN")
        return "\n".join(lines) + "\n"

    def save_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus())
