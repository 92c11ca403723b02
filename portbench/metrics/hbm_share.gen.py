"""The bytes the traced generate calls need (the configuration's
``counts``: every live self-cache K/V entry and every context's cross K/V
read once a step, the decoder's weights once a step, the cache writes and
the outputs) over (traced wall time x 3.35 TB/s)."""

from portbench.harness.peaks import HBM_BYTES_PER_S


def read(m):
    if m.kind != "generate" or m.trace is None or "bytes" not in m.work:
        return None
    return 100.0 * m.work["bytes"] * m.units / (m.trace.window_s * HBM_BYTES_PER_S)
