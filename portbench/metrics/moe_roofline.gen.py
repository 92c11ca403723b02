"""The expert layers' grouped GEMMs (``torch._grouped_mm``, a CUTLASS
grouped kernel on sm_90): their bound at the calls' shapes over their device
time, by kernel name, in the traced window.

Per GEMM of ``pairs`` (token, expert) rows, ``d_in`` to ``d_out``, over
``experts`` experts: bytes, every expert's weights (every expert is touched
at the cell's shapes) and the rows in and out once; operations 2 pairs d_in
d_out. At decode the bytes bound it, at prefill the operations. The shapes
come from the configuration's ``counts`` (``moe``: count, pairs, d_in,
d_out, experts), in bf16."""

import re

from portbench.harness.peaks import PEAK_FLOPS, bound_s

NAME = re.compile(r"GroupProblemShape|grouped_gemm|GroupedGemm|grouped_mm", re.I)


def bound(calls) -> float:
    total = 0.0
    for count, pairs, d_in, d_out, experts in calls:
        nbytes = 2 * (experts * d_in * d_out + pairs * (d_in + d_out))
        total += count * bound_s(nbytes, 2.0 * pairs * d_in * d_out, PEAK_FLOPS["bfloat16"])
    return total


def read(m):
    if m.kind != "generate" or m.trace is None or "moe" not in m.work:
        return None
    t = m.trace.device_s(lambda n: NAME.search(n) is not None)
    if t <= 0:
        return None
    return 100.0 * bound(m.work["moe"]) * m.units / t
