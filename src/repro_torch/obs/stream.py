"""Streaming flushes: rotating trace/metrics segments on the virtual clock.

The port's copy of ``repro.obs.stream``, pure Python: the same events, series
and bytes as the reference's for the same inputs.

A plain recorder is end-of-run only: it buffers every event until
``save()`` and the registry is scraped once at exit. For a long-lived
service that is unbounded memory and zero mid-run visibility. The
:class:`ObsFlusher` fixes both on the runtime's *virtual* clock (so flush
points — and therefore segment contents — are deterministic for a seeded
run):

  * every ``scrape_every_s`` virtual seconds it drains the recorder's
    completed request trees (:meth:`TraceRecorder.drain` — sampling and
    cap accounting happen there) into a rotating ``trace-<seq>.json``
    segment, and snapshots the :class:`MetricsRegistry` into
    ``metrics-<seq>.json`` + ``metrics-<seq>.prom``;
  * :meth:`finalize` force-drains whatever is still open, writes the last
    segments, and drops a ``manifest.json`` describing the run (segment
    list, sampler config, drop accounting, recorder peak).

Each trace segment is itself a valid Chrome trace document (loadable in
Perfetto on its own); :func:`concat_segments` stitches a segment directory back into
one document equivalent to what a non-streaming run would have saved,
modulo sampled-out trees.

Drive it from the host loop: the solo scheduler calls
:meth:`maybe_flush` once per dispatch step, the multi-worker plane calls
it at its deterministic event-loop points. The flusher keeps an internal
high-water mark, so calling it more often than ``scrape_every_s`` is
free, and a coarse caller just produces fewer, larger segments.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from repro_torch.obs.trace import (TraceRecorder, build_trace_doc,
                             trace_doc_to_json)

MANIFEST = "manifest.json"


class ObsFlusher:
    """Virtual-clock-driven segment writer for one run's recorder+registry."""

    def __init__(self, out_dir: str, *, recorder: Optional[TraceRecorder]
                 = None, registry=None, scrape_every_s: Optional[float]
                 = None, label: str = "run", include_wall: bool = False,
                 deterministic_metrics: bool = True):
        if recorder is None and registry is None:
            raise ValueError("flusher needs a recorder and/or a registry")
        if scrape_every_s is not None and scrape_every_s <= 0:
            raise ValueError("scrape_every_s must be > 0")
        self.out_dir = out_dir
        self.recorder = recorder
        self.registry = registry
        self.scrape_every_s = scrape_every_s
        self.label = label
        self.include_wall = include_wall
        self.deterministic_metrics = deterministic_metrics
        self.seq = 0
        self.trace_segments: List[str] = []
        self.metric_segments: List[str] = []
        self._next: Optional[float] = None   # next scheduled flush time
        self._finalized = False
        os.makedirs(out_dir, exist_ok=True)

    # -- driving -------------------------------------------------------------

    def maybe_flush(self, now: float) -> int:
        """Flush every ``scrape_every_s`` of virtual time; returns the number
        of flushes performed (0 almost always — cheap to call per step)."""
        if self.scrape_every_s is None or self._finalized:
            return 0
        if self._next is None:
            self._next = now + self.scrape_every_s
            return 0
        n = 0
        # Catch-up loop: a long quiet gap still yields one segment per
        # period boundary, so segment boundaries are a pure function of
        # virtual time, not of how often the host loop ticked.
        while now >= self._next:
            self.flush(self._next)
            self._next += self.scrape_every_s
            n += 1
        return n

    def flush(self, t: float, *, force: bool = False) -> None:
        """Write one segment pair stamped with virtual time ``t``."""
        seq = self.seq
        self.seq += 1
        if self.recorder is not None:
            events = self.recorder.drain(force=force)
            doc = build_trace_doc(
                events, label=self.label, include_wall=self.include_wall,
                other={"segment": seq, "t": t,
                       "drops": self.recorder.drop_stats})
            path = os.path.join(self.out_dir, f"trace-{seq:05d}.json")
            with open(path, "w") as f:
                f.write(trace_doc_to_json(doc))
            self.trace_segments.append(os.path.basename(path))
        if self.registry is not None:
            snap = {"segment": seq, "t": t,
                    "metrics": self.registry.snapshot(
                        deterministic=self.deterministic_metrics)}
            path = os.path.join(self.out_dir, f"metrics-{seq:05d}.json")
            with open(path, "w") as f:
                f.write(json.dumps(snap, sort_keys=True,
                                   separators=(",", ":")))
            self.metric_segments.append(os.path.basename(path))
            with open(os.path.join(self.out_dir,
                                   f"metrics-{seq:05d}.prom"), "w") as f:
                f.write(self.registry.prometheus(
                    deterministic=self.deterministic_metrics))

    def finalize(self, now: float) -> str:
        """Force-drain the tail, write the manifest; returns manifest path."""
        if not self._finalized:
            self.flush(now, force=True)
            self._finalized = True
        manifest = {
            "label": self.label,
            "scrape_every_s": self.scrape_every_s,
            "trace_segments": self.trace_segments,
            "metric_segments": self.metric_segments,
        }
        if self.recorder is not None:
            manifest["drops"] = self.recorder.drop_stats
            manifest["peak_buffered"] = self.recorder.peak_buffered
            if self.recorder.sampler is not None:
                manifest["sampler"] = self.recorder.sampler.describe()
        path = os.path.join(self.out_dir, MANIFEST)
        with open(path, "w") as f:
            f.write(json.dumps(manifest, sort_keys=True,
                               separators=(",", ":")))
        return path

    def describe(self) -> Dict:
        return {"out_dir": self.out_dir,
                "scrape_every_s": self.scrape_every_s,
                "segments": self.seq}


# -- segment stitching --------------------------------------------------------


def segment_paths(obs_dir: str) -> List[str]:
    """Trace segment files of an obs directory, in flush order (via the
    manifest when present, else by the zero-padded filename)."""
    mpath = os.path.join(obs_dir, MANIFEST)
    if os.path.exists(mpath):
        with open(mpath) as f:
            names = json.load(f).get("trace_segments", [])
    else:
        names = sorted(n for n in os.listdir(obs_dir)
                       if n.startswith("trace-") and n.endswith(".json"))
    return [os.path.join(obs_dir, n) for n in names]


def concat_segments(paths: List[str], label: Optional[str] = None) -> Dict:
    """Stitch trace segments into one valid Chrome trace document.

    Metadata (``ph: "M"``) rows are deduplicated per pid; event rows keep
    segment order (each segment is internally (ts, wid)-sorted, and later
    segments hold later-closing trees — Perfetto does not require global
    ts order). ``otherData`` reports the stitch and the final segment's
    drop accounting.
    """
    events: List[Dict] = []
    meta: Dict[int, Dict] = {}
    other: Dict = {}
    for path in paths:
        with open(path) as f:
            doc = json.load(f)
        for ev in doc.get("traceEvents", ()):
            if ev.get("ph") == "M":
                meta.setdefault(ev.get("pid", 0), ev)
            else:
                events.append(ev)
        other = doc.get("otherData", {}) or other
    out_other = {"label": label if label is not None
                 else other.get("label", "run"),
                 "deterministic": other.get("deterministic", True),
                 "segments": len(paths)}
    if "drops" in other:
        out_other["drops"] = other["drops"]
    return {
        "traceEvents": [meta[p] for p in sorted(meta)] + events,
        "displayTimeUnit": "ms",
        "otherData": out_other,
    }


def concat_dir(obs_dir: str, label: Optional[str] = None) -> Dict:
    return concat_segments(segment_paths(obs_dir), label=label)
