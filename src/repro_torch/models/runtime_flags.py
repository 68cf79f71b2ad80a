"""Runtime flags for roofline probing.

The port of ``repro.models.runtime_flags``. The reference's probe unrolls
its ``lax.scan`` loops so that XLA's cost analysis counts every trip; the
port's inner loops are Python loops already, and the dry-run counts each
op as it runs, so nothing needs unrolling. What carries over is the
probe's coarser flash tiles: under :func:`unroll_inner`,
``flash_attention`` takes q and k chunks of at least ``PROBE_FLASH_CHUNK``
(as ``src/repro/models/attention.py`` does), which bounds the op count of
a long-sequence trace; the masked diagonal tile's waste grows from about
chunk/2S to 4096/2S of the causal band.
"""
import contextlib

UNROLL_INNER = False
PROBE_FLASH_CHUNK = 4096


@contextlib.contextmanager
def unroll_inner():
    """The probe: coarse flash tiles for the enclosed code."""
    global UNROLL_INNER
    prev = UNROLL_INNER
    UNROLL_INNER = True
    try:
        yield
    finally:
        UNROLL_INNER = prev


def flash_chunk(chunk: int) -> int:
    """``chunk``, or at least ``PROBE_FLASH_CHUNK`` under the probe."""
    return max(chunk, PROBE_FLASH_CHUNK) if UNROLL_INNER else chunk
