"""Model operations of the traced generate calls (the configuration's
``counts``) over (traced wall time x the dtype's peak)."""

from portbench.harness.peaks import PEAK_FLOPS


def read(m):
    if m.kind != "generate" or m.trace is None or "flops" not in m.work:
        return None
    return 100.0 * m.work["flops"] * m.units / (m.trace.window_s * PEAK_FLOPS[m.work["dtype"]])
