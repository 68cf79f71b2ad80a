"""Share (%) of the traced slice in which the device is idle while the
program is in a decode step: the idle gaps (``DeviceTrace.idle_gaps``,
each named by the innermost host span open at its midpoint) that the
program's ``decode_step`` spans name, over the slice."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window is None or not any(r[0] == "pb:decode_step" for r in tr.ranges):
        return None
    idle = dict(tr.idle_gaps(top=None))
    return 100.0 * idle.get("decode_step", 0.0) / tr.window_s()
