"""Host spans and counters inside the port's serving path, on a clock that
lines up with a device trace.

Installed the way :func:`repro_torch.kernels.ops.set_kernel_profiler`
installs the kernel profiler: :func:`set_host_tracer` puts a
:class:`HostTracer` in the hook :data:`repro_torch.models.trace_hook.TRACER`,
and ``None`` (the default) turns it off. Each site reads the hook once and,
when it is ``None``, runs exactly the untraced code: no clock read, no
allocation. On or off, no span or counter syncs the device, reads a tensor
or launches a kernel.

The sites, by layer:

  * routing (``serving/engine.py``): ``featurize`` (``embed_texts``, with
    ``n``), ``score`` (the quality kernel, the cost head and both copies to
    the host, ``n``), ``choose`` (``n``);
  * engine (``RoutedEngine.generate_member``): ``generate`` (``member``,
    ``n``, ``max_new`` and the call's counts, :data:`COUNTS`), with the
    children ``pad`` (``pad_prompts`` and ``prompt_pad_mask``) and
    ``to_host`` (the copy of the tokens that waits for the device);
  * model step (``models/lm.py::greedy_generate``, so every caller of the
    loop): ``prefill`` (``b``, ``s``), then one ``decode_step`` (``i``) per
    step.

Spans land in the :class:`~repro_torch.obs.trace.TraceRecorder` given to
the tracer, under the wall-clock category :data:`HOST_CAT`, which the
deterministic export drops; nesting in time gives each span its parent;
:meth:`HostTracer.spans` gives them back. Their timestamps are seconds
since the tracer's anchor, read once when the tracer is made:
``time.time_ns()`` (:attr:`HostTracer.anchor_ns`), then
``time.perf_counter_ns()``. So :meth:`HostTracer.wall_ns` puts a stamp on
the real-time clock that ``torch.profiler`` stamps device events on, early
by at most the moment between the two reads.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

from repro_torch.models.trace_hook import set_host_tracer  # noqa: F401  (the install API)
from repro_torch.obs.trace import _ARGS, _CAT, _DUR, _NAME, _TS

# The recorder category of host spans (one of ``trace.WALL_CATS``).
HOST_CAT = "host"

# The counts of one generate call, carried as args of its ``generate`` span.
COUNTS = ("prefill_positions", "prefill_tokens", "decode_row_steps", "decode_row_steps_kept")


def generate_counts(prompt_lens: Sequence[int], caps: Sequence[int], max_new: int,
                    width: int) -> Dict[str, int]:
    """The counts of one generate call of ``len(prompt_lens)`` rows
    left-padded to ``width`` positions, decoding to ``max_new`` tokens when
    each request keeps at most its own cap: every row yields
    ``max(max_new, 1)`` tokens (the first from the prefill, the rest from
    one decode step each), of which a request keeps ``min(cap, tokens)``."""
    b, out = len(prompt_lens), max(int(max_new), 1)
    return {"prefill_positions": b * int(width),
            "prefill_tokens": sum(int(n) for n in prompt_lens),
            "decode_row_steps": b * (out - 1),
            "decode_row_steps_kept": sum(max(min(int(c), out) - 1, 0) for c in caps)}


class HostTracer:
    """Records host spans into ``recorder``."""

    def __init__(self, recorder):
        self.recorder = recorder
        self.anchor_ns = time.time_ns()
        self.anchor_perf_ns = time.perf_counter_ns()

    def now(self) -> float:
        """Seconds since the anchor."""
        return (time.perf_counter_ns() - self.anchor_perf_ns) * 1e-9

    def wall_ns(self, t: float) -> int:
        """``t`` (seconds since the anchor) on ``time.time_ns()``'s clock."""
        return self.anchor_ns + round(t * 1e9)

    def span(self, name: str, t0: float, args: Optional[dict] = None) -> float:
        """Record ``name`` from ``t0`` to now; returns now."""
        t1 = self.now()
        self.recorder.span(name, HOST_CAT, t0, t1, args=args)
        return t1

    def call(self, name: str, fn: Callable, *fn_args, **args):
        """``fn(*fn_args)`` inside a span ``name`` whose args are ``args``."""
        t0 = self.now()
        out = fn(*fn_args)
        self.span(name, t0, args)
        return out

    def generate(self, member: str, t0: float, prompt_lens: Sequence[int],
                 caps: Sequence[int], max_new: int, width: int) -> None:
        """Close the ``generate`` span of one call begun at ``t0``, its
        counts among the span's args."""
        self.span("generate", t0, {"member": member, "n": len(prompt_lens),
                                   "max_new": int(max_new),
                                   **generate_counts(prompt_lens, caps, max_new, width)})

    def spans(self) -> Iterator[Tuple[str, float, float, dict]]:
        """The recorded host spans, in order: ``(name, t0, dur, args)``,
        ``t0`` and ``dur`` in seconds on the anchor's clock."""
        for e in self.recorder.events:
            if e[_CAT] == HOST_CAT:
                yield e[_NAME], e[_TS], e[_DUR], e[_ARGS] or {}
