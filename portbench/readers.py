"""What the per-layer readers under ``metrics/`` share. Each reader takes
the run's context (host spans, request records, the device trace, the
window) and returns a number, or None where the run gave it nothing to
read."""
from __future__ import annotations

from typing import Dict, Optional

from portbench import roofline


def idle_share_pct(ctx: Dict) -> Optional[float]:
    """Share of the traced slice in which no device event ran."""
    tr = ctx.get("trace")
    if tr is None or tr.window is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())


def peak_gib(ctx: Dict) -> Optional[float]:
    peak = ctx.get("peak_window_bytes") or 0
    return peak / 2**30 if peak else None


def serving_mfu_pct(ctx: Dict) -> Optional[float]:
    """Forward FLOPs of the real prompt tokens and the delivered tokens of
    the generate calls made after the profiler stopped and done by the
    window's end, over that stretch at the fp32 peak (the profiler slows
    the host-bound decode loop, so the traced slice is left out)."""
    t_end, members = ctx["window_end_s"], ctx["members"]
    free = [s for s in ctx["spans"] if not s.get("traced") and s["t1"] <= t_end]
    calls = [s for s in free if s["name"] == "generate_member"]
    if not calls:
        return None
    t0 = min(s["t0"] for s in free)
    flops = 0.0
    for s in calls:
        m = members[s["member"]]
        flops += sum(roofline.generate_flops(m, p, d)
                     for p, d in zip(s["prompt_lens"], s["delivered"]))
    return 100.0 * flops / ((t_end - t0) * roofline.PEAK_FLOPS_FP32)


def train_mfu_pct(ctx: Dict) -> Optional[float]:
    """Forward and backward FLOPs of the real tokens of the window's steps
    over the window at the fp32 peak."""
    (m,) = ctx["members"].values()
    steps = [s for s in ctx["spans"] if s["name"] == "train_step"]
    if not steps:
        return None
    flops = sum(roofline.train_flops(m, s["lengths"]) for s in steps)
    return 100.0 * flops / (ctx["window_end_s"] * roofline.PEAK_FLOPS_FP32)
