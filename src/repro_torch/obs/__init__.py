"""Unified observability plane: tracing, metrics, streaming, SLOs.

Pillars over the serving fleet:

  * :mod:`repro_torch.obs.trace` — deterministic per-request trace spans over
    the runtime's virtual clocks, exported as Chrome-trace/Perfetto JSON
    (complete spans, instants, and native counter tracks);
  * :mod:`repro_torch.obs.metrics` — a counter/gauge/histogram registry with
    Prometheus-text and canonical-JSON exporters;
  * :mod:`repro_torch.obs.stream` — virtual-clock-driven segment flushes that
    bound recorder memory for long-lived runs, plus segment stitching;
  * :mod:`repro_torch.obs.sampling` — deterministic head+tail per-request trace
    sampling with an always-keep anomaly lane and a hard buffered cap;
  * :mod:`repro_torch.obs.slo` — SLO monitors with multi-window burn-rate
    alerting on the virtual clock;
  * :mod:`repro_torch.obs.scrape` — a localhost HTTP endpoint serving the live
    registry (``/metrics`` Prometheus text, ``/metrics.json``);
  * :mod:`repro_torch.obs.profiling` — wall-clock (+ optional torch
    profiler) timing hooks around the port's kernel entry points, synced
    to the device inside each span;
  * :mod:`repro_torch.obs.host_trace` — host spans and counters inside the
    routing, the generate call and the decode loop, on a clock that lines
    up with a device trace; off unless installed.

The port of ``repro.obs``, the same exports. ``repro_torch.obs.wiring``
registers the standard serving metric series; ``repro_torch.launch.serve``
wires everything into the serving entry point (``--trace-out/--metrics-out/
--scrape-every/--trace-sample/--slo-*``), and the reference's
``tools/trace_export.py`` reads the artifacts, which are the reference's
bytes for the same run.
"""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    HistogramMetric,
    MetricsRegistry,
    MultiGauge,
)
from repro_torch.obs.profiling import KernelProfiler
from repro_torch.obs.sampling import TraceSampler, is_anomaly_event
from repro_torch.obs.scrape import MetricsServer, merge_prom_texts
from repro_torch.obs.slo import (
    BurnRateSLO,
    RollingWindow,
    SLOTracker,
    SpendBurnSLO,
    build_slo_tracker,
)
from repro_torch.obs.stream import ObsFlusher, concat_dir, concat_segments
from repro_torch.obs.trace import (
    WALL_CATS,
    ScopedTrace,
    TraceRecorder,
    build_trace_doc,
    request_trees,
    trace_summary,
    validate_chrome_trace,
    validate_span_tree,
)
from repro_torch.obs.wiring import (
    register_governor_metrics,
    register_plane_metrics,
    register_scheduler_metrics,
    register_slo_metrics,
    register_stream_metrics,
    register_transport_metrics,
)

__all__ = [
    "BurnRateSLO",
    "Counter",
    "Gauge",
    "HistogramMetric",
    "KernelProfiler",
    "MetricsRegistry",
    "MetricsServer",
    "MultiGauge",
    "ObsFlusher",
    "RollingWindow",
    "SLOTracker",
    "ScopedTrace",
    "SpendBurnSLO",
    "TraceRecorder",
    "TraceSampler",
    "WALL_CATS",
    "build_slo_tracker",
    "build_trace_doc",
    "concat_dir",
    "concat_segments",
    "is_anomaly_event",
    "merge_prom_texts",
    "register_governor_metrics",
    "register_plane_metrics",
    "register_scheduler_metrics",
    "register_slo_metrics",
    "register_stream_metrics",
    "register_transport_metrics",
    "request_trees",
    "trace_summary",
    "validate_chrome_trace",
    "validate_span_tree",
]
