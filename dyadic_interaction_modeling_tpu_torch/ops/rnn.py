"""Multi-layer (bi)directional LSTM of the EMOCA-to-mesh heads.

Counterpart of ``dyadic_interaction_modeling_tpu/ops/rnn.py`` (the reference's
``nn.LSTM`` heads, seq2seq_pretrain.py:801-814). The JAX package's
parameters already carry ``torch.nn.LSTM``'s names and layout
(``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``, the
``_reverse`` direction, gate order i, f, g, o), so the port is
``nn.LSTM(batch_first=True)`` itself, returning the output sequence only.
The LSTM has no Pallas kernel in the JAX package: on the card it runs
cuDNN's RNN, which uses TF32 while ``torch.backends.cudnn.allow_tf32`` is
on (PyTorch's default).
"""

from __future__ import annotations

import torch
from torch import nn


class LSTM(nn.LSTM):
    """(B, L, input_size) -> (B, L, hidden_size * (2 if bidirectional else 1))."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True,
                         bidirectional=bidirectional)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(x)[0]
