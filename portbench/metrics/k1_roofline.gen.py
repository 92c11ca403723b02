"""K1 (``csrc/decode_attention.cu``): its bound at the calls' shapes over its
device time, by kernel name, in the traced window.

Bytes: each query row and output row once, the live keys and values of each
cache row once, the key mask once; operations 4 D a (query, key) pair. The
shapes come from the configuration's ``counts`` (``k1``: count, cache rows,
query rows a cache row, keys, D, mask bytes) and its dtype."""

import re

from portbench.harness.peaks import PEAK_FLOPS, bound_s

NAME = re.compile(r"\bdecode_(vec|mma)_kernel\b")


def bound(calls, dtype: str) -> float:
    es = 2 if dtype == "bfloat16" else 4
    total = 0.0
    for count, rows, nq, keys, d, mask in calls:
        nbytes = rows * (2 * nq * d + 2 * keys * d) * es + mask
        total += count * bound_s(nbytes, 4.0 * d * rows * nq * keys, PEAK_FLOPS[dtype])
    return total


def read(m):
    if m.kind != "generate" or m.trace is None or "k1" not in m.work:
        return None
    t = m.trace.device_s(lambda n: NAME.search(n) is not None)
    if t <= 0:
        return None
    return 100.0 * bound(m.work["k1"], m.work["dtype"]) * m.units / t
