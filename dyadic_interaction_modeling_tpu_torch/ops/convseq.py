"""Temporal conv squasher / expander of the VQ-VAEs (stage1_BIWI.py:263-393).

Counterpart of ``dyadic_interaction_modeling_tpu/ops/convseq.py:28-243``.
Activations stay in the JAX package's (B, L, C) layout at every public
function; the conv runs in torch's (B, C, L) layout inside. The module keys
follow the reference (``squasher.{i}.0`` conv or transposed conv,
``squasher.{i}.2`` affine instance norm). ``quant_factor == 0`` (the shipped
configuration) is one stride-1 block each way; ``quant_factor > 0``
downsamples time by 2 ** quant_factor (a stride-2 block, then MaxPool(2)
blocks) and the expander upsamples it back (a ConvTranspose block, then
conv blocks each followed by ``repeat_interleave(2)``). Only
``quant_factor == 0`` takes ``lengths`` (the masked per-sample path), as the
JAX package asserts.
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


def max_pool_time(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """MaxPool1d over the time axis of (B, L, C), stride = window, the tail
    that does not fill a window dropped."""
    b, l, c = x.shape
    n = l // window
    return x[:, : n * window].reshape(b, n, window, c).amax(dim=2)


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
    """Conv1d(k=5, pad=2, replicate) -> LeakyReLU -> InstanceNorm [->
    MaxPool(2)], keyed like the reference's ``nn.Sequential(conv, LeakyReLU,
    InstanceNorm1d[, MaxPool1d])``."""

    def __init__(self, dim_in: int, dim: int, stride: int = 1, neg: float = 0.2,
                 affine: bool = False, max_pool: bool = False):
        super().__init__(nn.Conv1d(dim_in, dim, 5), nn.LeakyReLU(neg),
                         _InstanceNormParams(dim) if affine else nn.Identity())
        self.stride, self.affine, self.max_pool = stride, affine, max_pool

    def _norm(self, x, lengths=None):
        scale = shift = None
        if self.affine:
            scale, shift = self[2].weight.to(x.dtype), self[2].bias.to(x.dtype)
        if lengths is not None:
            return masked_instance_norm_1d(x, lengths, scale=scale, bias=shift)
        return instance_norm_1d(x, scale=scale, bias=shift)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv = self[0]
        if lengths is not None:
            x = fill_pad_with_edge(x, lengths)
        x = conv1d_replicate(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                             self.stride, 2)
        x = self._norm(self[1](x), lengths)
        return max_pool_time(x, 2) if self.max_pool else x


class _TConvINBlock(_ConvINBlock):
    """ConvTranspose1d(k=5, stride 2, pad 2, output_padding 1) -> LeakyReLU
    -> InstanceNorm: the expander's first block at quant_factor > 0, time
    doubled. torch's ConvTranspose1d pads with zeros only; the reference's
    ``padding_mode='replicate'`` there is never applied."""

    def __init__(self, dim_in: int, dim: int, neg: float = 0.2, affine: bool = False):
        super().__init__(dim_in, dim, 2, neg, affine)
        self[0] = nn.ConvTranspose1d(dim_in, dim, 5, stride=2, padding=2, output_padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self[0]
        x = F.conv_transpose1d(x.transpose(1, 2), conv.weight.to(x.dtype),
                               conv.bias.to(x.dtype), stride=2, padding=2,
                               output_padding=1).transpose(1, 2)
        return self._norm(self[1](x))


def _unmasked(quant_factor: int, lengths) -> None:
    if lengths is not None and quant_factor != 0:
        raise ValueError("the masked (lengths) path takes quant_factor == 0 only, as the "
                         f"JAX package asserts; got quant_factor {quant_factor}")


class ConvSquasher(nn.Sequential):
    """Encoder squasher: one stride-1 block at quant_factor == 0, else a
    stride-2 block and quant_factor - 1 stride-1 + MaxPool(2) blocks (time
    / 2 ** quant_factor)."""

    def __init__(self, dim_in: int, dim: int, quant_factor: int = 0,
                 neg: float = 0.2, affine: bool = False):
        blocks = [_ConvINBlock(dim_in, dim, 2 if quant_factor else 1, neg, affine)]
        blocks += [_ConvINBlock(dim, dim, 1, neg, affine, max_pool=True)
                   for _ in range(1, quant_factor)]
        super().__init__(*blocks)
        self.quant_factor = quant_factor

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        _unmasked(self.quant_factor, lengths)
        x = self[0](x, lengths)
        for block in list(self)[1:]:
            x = block(x)
        return x


class ConvExpander(nn.Sequential):
    """Decoder expander: one stride-1 block at quant_factor == 0, else a
    ConvTranspose block (time x 2) and then quant_factor - 1 conv blocks
    (quant_factor + 1 with ``is_audio``), each followed by
    ``repeat_interleave(2)`` over time (stage1_BIWI.py:376-393)."""

    def __init__(self, dim_in: int, dim: int, quant_factor: int = 0,
                 neg: float = 0.2, affine: bool = False, is_audio: bool = False):
        if quant_factor == 0:
            blocks = [_ConvINBlock(dim_in, dim, 1, neg, affine)]
        else:
            n_layers = quant_factor + 2 if is_audio else quant_factor
            blocks = [_TConvINBlock(dim_in, dim, neg, affine)]
            blocks += [_ConvINBlock(dim, dim, 1, neg, affine) for _ in range(1, n_layers)]
        super().__init__(*blocks)
        self.quant_factor = quant_factor

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        _unmasked(self.quant_factor, lengths)
        if self.quant_factor == 0:
            return self[0](x, lengths)
        x = self[0](x)
        for block in list(self)[1:]:
            x = block(x).repeat_interleave(2, dim=1)
        return x
