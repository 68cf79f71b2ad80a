"""Share (%) of the decode row-steps whose token no request keeps: 1 - the
row-steps inside each request's own ``max_new`` over the rows times the
steps the call decodes (to its longest ``max_new``), summed over the
program's ``generate`` calls done by the window's end."""
from portbench.host_spans import done


def read(ctx):
    calls = done(ctx, "generate")
    row_steps = sum(s["decode_row_steps"] for s in calls)
    if not row_steps:
        return None
    return 100.0 * (1.0 - sum(s["decode_row_steps_kept"] for s in calls) / row_steps)
