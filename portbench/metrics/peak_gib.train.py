"""Device memory peak over the window (GiB): ``max_memory_allocated``
after ``reset_peak_memory_stats`` at the window's start."""
from portbench.readers import peak_gib


def read(ctx):
    return peak_gib(ctx)
