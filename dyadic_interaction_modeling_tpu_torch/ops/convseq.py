"""Temporal conv squasher / expander of the VQ-VAEs (stage1_BIWI.py:263-353).

Counterpart of ``dyadic_interaction_modeling_tpu/ops/convseq.py:28-223`` for
``quant_factor == 0``, the shipped configuration. Activations stay in the JAX
package's (B, L, C) layout at every public function; the conv runs in torch's
(B, C, L) layout inside. The module keys follow the reference
(``squasher.0.0`` conv, ``squasher.0.2`` affine instance norm).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def conv1d_replicate(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     stride: int, pad: int) -> torch.Tensor:
    """``nn.Conv1d(..., padding=pad, padding_mode='replicate')`` on (B, L, Cin);
    ``w`` in torch's (Cout, Cin, K) layout. Returns (B, L', Cout)."""
    h = x.transpose(1, 2)
    if pad:
        h = F.pad(h, (pad, pad), mode="replicate")
    return F.conv1d(h, w, b, stride=stride).transpose(1, 2)


def instance_norm_1d(x: torch.Tensor, eps: float = 1e-5,
                     scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """InstanceNorm1d over the time axis of (B, L, C), biased variance."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def fill_pad_with_edge(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Replace padded frames with each sequence's last valid frame, so a
    batched replicate-padded conv equals the per-sample one at every valid
    position."""
    b, l, c = x.shape
    pos = torch.arange(l, device=x.device)[None, :]
    idx = torch.minimum(pos, lengths[:, None].to(pos.dtype) - 1)
    return torch.gather(x, 1, idx[:, :, None].expand(b, l, c))


def masked_instance_norm_1d(x: torch.Tensor, lengths: torch.Tensor,
                            eps: float = 1e-5,
                            scale: Optional[torch.Tensor] = None,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """InstanceNorm1d over only the first ``lengths`` frames of each sample;
    padded positions get values that downstream masks must ignore."""
    l = x.shape[1]
    m = (torch.arange(l, device=x.device)[None, :]
         < lengths[:, None]).to(x.dtype)[:, :, None]
    denom = torch.clamp(lengths.to(x.dtype), min=1.0)[:, None, None]
    mean = (x * m).sum(dim=1, keepdim=True) / denom
    var = ((x - mean).square() * m).sum(dim=1, keepdim=True) / denom
    out = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


class _InstanceNormParams(nn.Module):
    """Holds the affine instance-norm parameters under the reference's
    ``weight``/``bias`` names; the normalisation itself is functional."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class _ConvINBlock(nn.Sequential):
    """Conv1d(k=5, pad=2, replicate) -> LeakyReLU -> InstanceNorm, keyed like
    the reference's ``nn.Sequential(conv, LeakyReLU, InstanceNorm1d)``."""

    def __init__(self, dim_in: int, dim: int, stride: int = 1, neg: float = 0.2,
                 affine: bool = False):
        super().__init__(nn.Conv1d(dim_in, dim, 5), nn.LeakyReLU(neg),
                         _InstanceNormParams(dim) if affine else nn.Identity())
        self.stride, self.affine = stride, affine

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv = self[0]
        if lengths is not None:
            x = fill_pad_with_edge(x, lengths)
        x = conv1d_replicate(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                             self.stride, 2)
        x = self[1](x)
        scale = shift = None
        if self.affine:
            scale, shift = self[2].weight.to(x.dtype), self[2].bias.to(x.dtype)
        if lengths is not None:
            return masked_instance_norm_1d(x, lengths, scale=scale, bias=shift)
        return instance_norm_1d(x, scale=scale, bias=shift)


def _check_quant_factor(quant_factor: int) -> None:
    if quant_factor != 0:
        raise NotImplementedError(
            "the torch port implements quant_factor == 0 only (the shipped "
            "VQ config); quant_factor > 0 is queued in ROADMAP.md")


class ConvSquasher(nn.Sequential):
    """Encoder squasher: one stride-1 conv block at quant_factor == 0."""

    def __init__(self, dim_in: int, dim: int, quant_factor: int = 0,
                 neg: float = 0.2, affine: bool = False):
        _check_quant_factor(quant_factor)
        super().__init__(_ConvINBlock(dim_in, dim, 1, neg, affine))

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self[0](x, lengths)


class ConvExpander(ConvSquasher):
    """Decoder expander: one stride-1 conv block at quant_factor == 0."""
