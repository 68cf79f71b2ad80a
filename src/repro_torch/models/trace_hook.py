"""The host tracer's hook: :data:`TRACER` holds the installed
:class:`repro_torch.obs.host_trace.HostTracer`, or ``None`` (off, the
default).

A leaf module, so that the model and serving layers read the hook without
importing the observability package, as ``kernels/ops.py`` holds the
kernel profiler's. Each site reads :data:`TRACER` once and, when it is
``None``, runs exactly the untraced code.
"""
from __future__ import annotations

TRACER = None


def set_host_tracer(tracer) -> None:
    """Install (or with ``None`` remove) the host tracer."""
    global TRACER
    TRACER = tracer
