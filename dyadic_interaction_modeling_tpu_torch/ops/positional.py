"""Sinusoidal positional encoding of the VQ-VAEs (base_models.py:258-273).

Counterpart of ``dyadic_interaction_modeling_tpu/ops/positional.py:26-74``.
"""

from __future__ import annotations

import math

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


class PositionalEncoding(nn.Module):
    """Sinusoidal PE, bug-compatible with the reference.

    The ``pe`` buffer has the reference's (max_len, 1, d_model) shape, so a
    reference state_dict loads with ``strict=True``. Modes:

    * ``batch`` (the reference quirk): row ``b`` of a batch-first input gets
      the encoding of position ``b`` on every frame;
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
            return x + pe[: x.shape[0], None, :]
        raise ValueError(f"unknown positional mode {mode!r}")
