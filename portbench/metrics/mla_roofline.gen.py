"""K5 (``csrc/latent_decode.cu``): its bound at the calls' shapes over its
device time, by kernel name (the key splits and, where a call splits, their
combine), in the traced window.

Bytes: each query row and output row once, the live latent rows of each
cache row once; operations 2 (Dk + Dv) a (query row, key) pair. The shapes
come from the configuration's ``counts`` (``k5``: count, cache rows, live
keys, query rows a cache row, Dk, Dv), in bf16."""

import re

from portbench.harness.peaks import PEAK_FLOPS, bound_s

NAME = re.compile(r"\blatent_(decode|combine)_kernel\b")


def bound(calls) -> float:
    total = 0.0
    for count, rows, keys, nq, dk, dv in calls:
        nbytes = 2 * rows * (keys * dk + nq * (dk + dv))
        total += count * bound_s(nbytes, 2.0 * (dk + dv) * rows * nq * keys,
                                 PEAK_FLOPS["bfloat16"])
    return total


def read(m):
    if m.kind != "generate" or m.trace is None or "k5" not in m.work:
        return None
    t = m.trace.device_s(lambda n: NAME.search(n) is not None)
    if t <= 0:
        return None
    return 100.0 * bound(m.work["k5"]) * m.units / t
