"""Host milliseconds per decode step of the port's greedy loop: the mean
length of the program's ``decode_step`` spans (``models/lm.py::
greedy_generate``: from the previous step's end to this step's last
launch, no device sync) that begin after the traced slice (the profiler
slows the host-bound loop) and end by the window's end."""
from portbench.host_spans import done


def read(ctx):
    tr = ctx.get("trace")
    after = tr.window[1] if tr is not None and tr.window is not None else None
    steps = [s for s in done(ctx, "decode_step") if after is None or s["ns0"] >= after]
    return 1e3 * sum(s["t1"] - s["t0"] for s in steps) / len(steps) if steps else None
