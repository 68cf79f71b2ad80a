"""``router_xattn``'s share (%) of its roofline: per launch the least time
of its shapes (its FLOPs over 67 TFLOP/s or its bytes over 3.35 TB/s,
whichever is larger), summed over the traced slice's launches, over the
profiler's device time of those launches. One launch per ``score_texts``
call of the engine wrapper; its batch is that call's request count."""
from portbench.roofline import router_xattn_least_s


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window is None:
        return None
    times = tr.kernel_durations("router_xattn")
    calls = [s for s in ctx["spans"] if s["name"] == "score_texts" and s.get("traced")]
    if not times or len(times) != len(calls):
        return None
    p = ctx["router"]["quality"]
    dq, d = p["wq"].shape
    k = p["wo"].shape[1]
    least = sum(router_xattn_least_s(s["n"], dq, d, k) for s in calls)
    return 100.0 * least / sum(times)
