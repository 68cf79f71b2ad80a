"""Device idle share (%) of the traced slice: 1 - the union of the device
events' intervals over the slice (torch.profiler's kineto events)."""
from portbench.readers import idle_share_pct


def read(ctx):
    return idle_share_pct(ctx)
