"""The program's own host spans and counters (``repro_torch.obs.host_trace``)
for a serving window, on the harness's clocks.

:func:`open_window` installs the port's host tracer and :func:`close_window`
removes it. :func:`program_spans` then gives the spans that began once the
window opened, through ``HostTracer.spans()``, as the readers take them:
``name``, ``t0`` and ``t1`` in seconds on the engine wrapper's clock
(``SpanLog``), ``ns0`` and ``ns1`` on ``time.time_ns()`` (the clock kineto
stamps device events on), and the span's args, a generate call's counts
among them. :func:`attach` puts them in the readers' context under
``program_spans`` and, in a traced run, into ``DeviceTrace.add_spans``, so
that each idle gap is named by the innermost program span open over it.
``portbench/host_window.py`` runs a window so; :data:`READERS` are the
metrics that read them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

# The readers of the program's spans, with their units.
READERS = {"decode_ms_per_step.backlog": "ms", "decode_idle_share.backlog": "%",
           "prefill_pad_share.backlog": "%", "decode_waste_share.backlog": "%",
           "featurize_ms_per_req.backlog": "ms"}


def open_window():
    """A fresh host tracer, installed; returns it."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.obs.host_trace import HostTracer, set_host_tracer
    tracer = HostTracer(TraceRecorder(label="portbench"))
    set_host_tracer(tracer)
    return tracer


def close_window() -> None:
    from repro_torch.obs.host_trace import set_host_tracer
    set_host_tracer(None)


def program_spans(tracer, t0: float) -> List[Dict]:
    """``tracer``'s spans that began at or after ``t0`` (a
    ``time.perf_counter()`` reading), timed from it and on
    ``time.time_ns()``."""
    base = tracer.anchor_perf_ns * 1e-9 - t0
    return [dict(args, name=name, t0=base + ts, t1=base + ts + dur,
                 ns0=tracer.wall_ns(ts), ns1=tracer.wall_ns(ts + dur))
            for name, ts, dur, args in tracer.spans() if base + ts >= 0]


def attach(ctx: Dict, trace: Optional[object], tracer, t0: float) -> None:
    """The window's program spans into the readers' ``ctx`` and, where the
    run is traced, into ``trace``'s host ranges."""
    ctx["program_spans"] = program_spans(tracer, t0)
    if trace is not None:
        trace.add_spans(ctx["program_spans"])


def done(ctx: Dict, name: str) -> List[Dict]:
    """The program's ``name`` spans that ended by the window's end (none
    where the run recorded no program spans)."""
    return [s for s in ctx.get("program_spans") or ()
            if s["name"] == name and s["t1"] <= ctx["window_end_s"]]
