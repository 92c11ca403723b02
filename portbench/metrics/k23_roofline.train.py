"""K2 + K3 (``csrc/flash_attention_mma.cu`` bf16, ``csrc/flash_attention.cu``
fp32): the bound of the attention forward and backward at the step's
shapes over their device time, by kernel name, in the traced window.

Frozen from ``chip_smoke._attn_bound`` at commit
b5205ad5a7d96ed2c2fe9e7fed8fc49e99a4e0cc: bytes each input is read and each
output written once, of K and V only the keys the mask keeps, the fp32 lse
and the mask; operations 4 D a (query, key) pair forward (Q K^T, P V), 10 D
backward (Q K^T, dO V^T, P^T dO, dS K, dS^T Q), at 989 TFLOP/s in bf16 and
in fp32 at the 3xTF32 rate, 495 / 3. Shapes from the configuration's
``counts`` (``k23``: count, rows, L, D, causal, keys kept, mask rows)."""

import re

from portbench.harness.peaks import FP32_3XTF32_FLOPS, PEAK_FLOPS, bound_s

NAME = re.compile(r"\bflash_(fwd|bwd_dq|bwd_dkdv)(_mma)?_kernel\b")


def bound(calls, dtype: str) -> float:
    es = 2 if dtype == "bfloat16" else 4
    rate = PEAK_FLOPS["bfloat16"] if dtype == "bfloat16" else FP32_3XTF32_FLOPS
    total = 0.0
    for count, rows, l, d, causal, kept, mask_rows in calls:
        pairs = rows * l * (l + 1) / 2.0 if causal else rows * l * float(kept)
        io = rows * l * d * es
        kv = rows * kept * d * es
        extra = rows * l * 4 + mask_rows * l
        fwd = bound_s(2 * io + 2 * kv + extra, 4.0 * d * pairs, rate)
        bwd = bound_s(6 * io + 2 * kv + extra, 10.0 * d * pairs, rate)
        total += count * (fwd + bwd)
    return total


def read(m):
    if m.kind != "train" or m.trace is None or "k23" not in m.work:
        return None
    t = m.trace.device_s(lambda n: NAME.search(n) is not None)
    if t <= 0:
        return None
    return 100.0 * bound(m.work["k23"], m.work["dtype"]) * m.units / t
