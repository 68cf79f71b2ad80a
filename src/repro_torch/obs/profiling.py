"""Kernel profiling hooks: wall-clock timing (and optional torch profiler
ranges) around the port's kernel entry points.

The port of ``repro.obs.profiling``. :mod:`repro_torch.kernels.ops`
exposes :func:`repro_torch.kernels.ops.set_kernel_profiler`; installing a
:class:`KernelProfiler` there makes every ``router_xattn_pool`` /
``pairwise_l2`` dispatch

  * land in a per-kernel log-bucketed latency :class:`Histogram`
    (µs per call, plus call/element counters), and
  * optionally emit a per-batch ``cat="kernel"`` span into a
    :class:`~repro_torch.obs.trace.TraceRecorder`.

Kernel spans are the one place the trace touches the wall clock, so they
live in :data:`~repro_torch.obs.trace.WALL_CATS` and are excluded from
the deterministic export — replay bit-identity is unaffected. Timestamps
are wall seconds relative to profiler construction. With a profiler
installed, the entry point synchronizes the result's CUDA device inside
the span (the reference's ``jax.block_until_ready``), so a span on the
card covers the kernel's device work, not only its launch.

When ``use_torch_profiler=True`` each dispatch also runs under
``torch.profiler.record_function`` so the spans line up with the
device's own timeline in a ``torch.profiler`` capture (the reference's
``jax.profiler.TraceAnnotation``); the wall-clock path always runs.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from repro_torch.serving.telemetry import Histogram


class KernelProfiler:
    """Collects per-kernel dispatch timings; optionally feeds a tracer."""

    def __init__(self, tracer=None, use_torch_profiler: bool = False):
        self.tracer = tracer
        self.use_torch_profiler = use_torch_profiler
        self.hists: Dict[str, Histogram] = {}
        self.calls: Dict[str, int] = {}
        self.elements: Dict[str, int] = {}
        self._t0 = time.perf_counter()

    @contextmanager
    def annotate(self, name: str, batch: Optional[int] = None):
        """Time one kernel dispatch (``with profiler.annotate("pairwise_l2",
        batch=B):``)."""
        ann = (torch.profiler.record_function(name)
               if self.use_torch_profiler else None)
        if ann is not None:
            ann.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if ann is not None:
                ann.__exit__(None, None, None)
            self._record(name, t0, t1, batch)

    def _record(self, name, t0, t1, batch):
        us = (t1 - t0) * 1e6
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
            self.calls[name] = 0
            self.elements[name] = 0
        h.record(us)
        self.calls[name] += 1
        if batch is not None:
            self.elements[name] += int(batch)
        if self.tracer is not None:
            args = {"us": round(us, 3)}
            if batch is not None:
                args["batch"] = int(batch)
            self.tracer.span(f"kernel:{name}", "kernel",
                             t0 - self._t0, t1 - self._t0, args=args)

    # -- reporting -----------------------------------------------------------

    def summary(self) -> Dict[str, Dict]:
        out = {}
        for name in sorted(self.hists):
            h = self.hists[name]
            out[name] = {
                "calls": self.calls[name],
                "elements": self.elements[name],
                "p50_us": h.percentile(50),
                "p99_us": h.percentile(99),
                "total_ms": h.total / 1e3,
            }
        return out

    def register_metrics(self, registry, prefix: str = "kernel") -> None:
        """Expose per-kernel series on a MetricsRegistry (all wall-clock)."""
        for name in sorted(self.hists):
            labels = (("op", name),)
            registry.counter(f"{prefix}_calls_total", "kernel dispatches",
                             labels=labels, wall=True,
                             fn=lambda n=name: self.calls[n])
            registry.counter(f"{prefix}_elements_total",
                             "rows processed by kernel dispatches",
                             labels=labels, wall=True,
                             fn=lambda n=name: self.elements[n])
            registry.histogram(f"{prefix}_latency_us",
                               "kernel dispatch wall latency (us)",
                               labels=labels, wall=True,
                               fn=lambda n=name: self.hists[n])

    def report(self) -> str:
        lines = ["kernel profile:"]
        for name, s in self.summary().items():
            lines.append(
                f"  {name:<20s} calls {s['calls']:>6d}  rows "
                f"{s['elements']:>8d}  p50 {s['p50_us']:>9.1f}us  "
                f"p99 {s['p99_us']:>9.1f}us  total {s['total_ms']:.1f}ms")
        if len(lines) == 1:
            lines.append("  (no kernel dispatches recorded)")
        return "\n".join(lines)
