"""Positional encodings and attention-bias masks.

Counterpart of ``dyadic_interaction_modeling_tpu/ops/positional.py:26-157``:
the VQ-VAEs' sinusoidal ``PositionalEncoding`` (base_models.py:258-273), the
learned ``PositionEmbedding`` (base_models.py:248-256), FaceFormer's
``PeriodicPositionalEncoding``, ALiBi-biased causal mask and
``enc_dec_mask`` (models/utils.py:8-58).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import numpy as np
import torch
from torch import nn


def sinusoid_table(max_len: int, d_model: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Standard transformer sin/cos table, shape (max_len, d_model), built in
    float64 and then cast (the same rounding as the JAX package)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.as_tensor(pe, dtype=dtype, device=device)


_ROW_OFFSET = [0]


@contextlib.contextmanager
def batch_row_offset(offset: int) -> Iterator[None]:
    """Within it, ``PositionalEncoding``'s ``batch`` mode gives row ``b``
    the encoding of position ``offset + b``: a rank holding rows ``[offset,
    offset + B)`` of a global batch (``parallel.MeshPlan.batches``) encodes
    them as the whole batch does in one process.

    The offset is process-wide state owned by the layer above:
    ``MeshPlan.batches`` holds it across each ``yield``, so it covers the
    step a training loop runs on the slice it was given, and nothing else
    of this module sets it."""
    before, _ROW_OFFSET[0] = _ROW_OFFSET[0], offset
    try:
        yield
    finally:
        _ROW_OFFSET[0] = before


class PositionalEncoding(nn.Module):
    """Sinusoidal PE, bug-compatible with the reference.

    The ``pe`` buffer has the reference's (max_len, 1, d_model) shape, so a
    reference state_dict loads with ``strict=True``. Modes:

    * ``batch`` (the reference quirk): row ``b`` of a batch-first input gets
      the encoding of position ``b`` on every frame (``b`` counted from
      ``batch_row_offset``, 0 outside it);
    * ``single``: every row gets position 0 (the reference encoding one
      sample at a time);
    * ``time``: the conventional per-frame encoding.
    """

    def __init__(self, d_model: int, max_len: int = 5000):
        super().__init__()
        self.register_buffer("pe", sinusoid_table(max_len, d_model)[:, None, :])

    def forward(self, x: torch.Tensor, mode: str = "batch") -> torch.Tensor:
        pe = self.pe[:, 0].to(x.dtype)
        if mode == "time":
            return x + pe[None, : x.shape[1], :]
        if mode == "single":
            return x + pe[0][None, None, :]
        if mode == "batch":
            off = _ROW_OFFSET[0]
            return x + pe[off: off + x.shape[0], None, :]
        raise ValueError(f"unknown positional mode {mode!r}")


class PositionEmbedding(nn.Module):
    """Learned position embedding, zero-initialised, added to every row:
    (seq_length, dim) ``pos_embedding``."""

    def __init__(self, seq_length: int, dim: int):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.zeros(seq_length, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pos_embedding.to(x.dtype)


class PeriodicPositionalEncoding(nn.Module):
    """A sin/cos table of ``period`` rows tiled past ``max_seq_len``; the
    ``pe`` buffer has the reference's (1, period * repeats, d_model) shape.
    Dropout applies in training mode only."""

    def __init__(self, d_model: int, period: int = 25, max_seq_len: int = 600,
                 dropout: float = 0.1):
        super().__init__()
        repeat = max_seq_len // period + 1
        self.register_buffer("pe", sinusoid_table(period, d_model).repeat(repeat, 1)[None])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.pe[:, : x.shape[1]].to(x.dtype))


def _alibi_slopes(n_head: int) -> np.ndarray:
    """FaceFormer's ALiBi head slopes (models/utils.py:9-18)."""

    def power_of_2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_head).is_integer():
        return np.asarray(power_of_2(n_head))
    closest = 2 ** math.floor(math.log2(n_head))
    extra = _alibi_slopes(2 * closest)[0::2][: n_head - closest]
    return np.asarray(power_of_2(closest) + list(extra))


def init_biased_mask(n_head: int, max_seq_len: int, period: int,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """(n_head, max_seq_len, max_seq_len) fp32: -inf above the diagonal,
    ``-slope_h * floor((i - j) / period)`` at i >= j (models/utils.py:8-29)."""
    slopes = _alibi_slopes(n_head)
    i = np.arange(max_seq_len)[:, None]
    j = np.arange(max_seq_len)[None, :]
    alibi = -np.floor((i - j) / period) * (i >= j)
    causal = np.where(j > i, -np.inf, 0.0)
    out = slopes[:, None, None] * alibi[None] + causal[None]
    return torch.as_tensor(out, dtype=torch.float32, device=device)


def enc_dec_mask(dataset: str, T: int, S: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Bool (T, S) alignment mask of the decoder's attention over audio,
    True = masked (models/utils.py:32-40): BIWI motion frame i sees audio
    frames 2i and 2i + 1, vocaset frame i audio frame i."""
    i = np.arange(T)[:, None]
    j = np.arange(S)[None, :]
    if dataset == "BIWI":
        allowed = (j == 2 * i) | (j == 2 * i + 1)
    elif dataset == "vocaset":
        allowed = j == i
    else:
        raise ValueError(f"unknown dataset for enc_dec_mask: {dataset}")
    return torch.as_tensor(~allowed, device=device)
