"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates), frozen
from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``PEAK_OPS``, ``FP32_ATTN_OPS``)
at commit b5205ad5a7d96ed2c2fe9e7fed8fc49e99a4e0cc. They assume the card's
full 700 W; every share is printed beside the card's power limit."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# fp32 attention on the tensor cores in 3xTF32: three TF32 operations
# (495 TFLOP/s) for each fp32 one
FP32_3XTF32_FLOPS = 495e12 / 3


def bound_s(nbytes: float, flops: float, flops_per_s: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the given peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)
