"""The traced run's device picture: ``torch.profiler`` over a slice of the
window, device activity only, read from the profiler's raw kineto events
(building its Python event tree takes minutes for a few hundred thousand
launches). Recording the host's operators too would slow a host-bound
serving loop by half and distort every number read beside it.

Kineto stamps device events on the host's real-time clock in ns, the
clock of ``time.time_ns()``, so the harness's own host spans (the engine
wrapper's calls, the loop's waits and steps) line up with them. Device
busy time is the union of the device events' intervals inside the
slice; an idle gap is a stretch of the slice no device event covers,
named by the innermost host span open at its midpoint, else ``host``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch



class DeviceTrace:
    def __init__(self):
        self._prof = None
        self._t0 = 0
        self.kernels: List[Tuple[str, int, int]] = []      # (name, start_ns, end_ns)
        self.ranges: List[Tuple[str, int, int]] = []       # host pb: ranges
        self.window: Optional[Tuple[int, int]] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.time_ns()

    @property
    def running(self) -> bool:
        return self._prof is not None

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.window = (self._t0, time.time_ns())
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                t0 = ev.start_ns()
                self.kernels.append((ev.name(), t0, t0 + ev.duration_ns()))
        self._prof = None
        self.kernels.sort(key=lambda e: e[1])

    def add_spans(self, spans: List[Dict]) -> None:
        """The host spans that carry real-time stamps (``ns0``, ``ns1``)."""
        self.ranges += [(f"pb:{s['name']}", s["ns0"], s["ns1"]) for s in spans if "ns0" in s]

    # -- reductions ---------------------------------------------------------

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        merged: List[List[int]] = []
        for _, a, b in self.kernels:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        out, cur = [], lo
        for a, b in self.busy_intervals():
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if hi > cur:
            out.append((cur, hi))
        return out

    def labels(self, times: List[int]) -> List[str]:
        """The innermost ``pb:`` range open at each of the sorted
        ``times`` (ranges nest, as calls do), or ``host``."""
        ranges = sorted(self.ranges, key=lambda r: r[1])
        out, stack, i = [], [], 0
        for t in times:
            while i < len(ranges) and ranges[i][1] <= t:
                stack.append(ranges[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            out.append(stack[-1][0][3:] if stack else "host")
        return out

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        lo, hi = self.window
        for name, a, b in self.kernels:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                by[name] = by.get(name, 0) + (b - a)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds summed by what the host was doing."""
        gaps = self.gaps()
        by: Dict[str, int] = {}
        for (a, b), label in zip(gaps, self.labels([(a + b) // 2 for a, b in gaps])):
            by[label] = by.get(label, 0) + (b - a)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]

    def kernel_durations(self, needle: str) -> List[float]:
        """Seconds of each device event whose name holds ``needle``, in
        launch order, inside the slice."""
        lo, hi = self.window
        return [(b - a) / 1e9 for name, a, b in self.kernels
                if needle in name and a >= lo and b <= hi]



def device_fields(trace: DeviceTrace) -> Dict[str, float]:
    return {"busy_s": trace.busy_s(), "window_s": trace.window_s()}


def breakdown(trace: DeviceTrace) -> Dict:
    return {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}

