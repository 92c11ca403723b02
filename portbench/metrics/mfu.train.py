"""Model operations of the traced training steps (forward and backward of
the trainable part, forward of the frozen part; the configuration's
``counts``) over (traced wall time x the dtype's peak: 989 TFLOP/s bf16,
67 fp32)."""

from portbench.harness.peaks import PEAK_FLOPS


def read(m):
    if m.kind != "train" or m.trace is None or "flops" not in m.work:
        return None
    return 100.0 * m.work["flops"] * m.units / (m.trace.window_s * PEAK_FLOPS[m.work["dtype"]])
