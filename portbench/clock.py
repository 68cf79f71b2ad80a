"""A wall clock with the interface of the scheduler's ``SimClock``."""
from __future__ import annotations

import time


class WallClock:
    """``now`` is seconds since :meth:`start` on the host's monotonic clock.
    ``advance`` does not jump (the scheduler calls it with the wall time a
    call already took); ``advance_to`` sleeps until then."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def start(self) -> None:
        self.t0 = time.perf_counter()

    @property
    def now(self) -> float:
        return time.perf_counter() - self.t0

    def advance(self, dt: float) -> None:
        del dt

    def advance_to(self, t: float) -> None:
        wait = t - self.now
        if wait > 0:
            time.sleep(wait)
