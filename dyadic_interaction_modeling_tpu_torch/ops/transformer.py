"""Pre-norm transformer blocks of the VQ-VAEs (base_models.py:9-210).

Counterpart of ``dyadic_interaction_modeling_tpu/ops/transformer.py:49-214``.
Module keys follow the reference: ``net.{2j}.fn.norm`` / ``net.{2j}.fn.fn``
(Residual(Norm(Attention))) and ``net.{2j+1}.fn.norm`` / ``net.{2j+1}.fn.fn``
(Residual(Norm(MLP))); the JAX package's ``TransformerBlock`` is the pair
``net.{2j}``, ``net.{2j+1}``.

``CrossModalAttention`` (queries from one stream, keys and values from the
other), the cross-modal ``Transformer`` (``cross_modal=True``: the query
stream ``context`` is fixed across layers and only the K/V stream is normed
and updated, base_models.py:17-20, :34-36), ``AudioEmbedding`` and
``CrossModalLayer`` (FACT's) always take the dense ``attend``, as in the JAX
package, where only ``Attention`` reaches the flash kernel.

Reproduced reference quirks:

* the attention scale is ``hidden_size ** -0.5``, the full width, not the
  per-head width;
* GELU is the tanh approximation;
* LayerNorm eps is 1e-5.

Attention over L >= ``FLASH_MIN_LEN`` keys without a mask, or with only a
(B, 1, Lk) key mask, at a head width K2/K3 are built for (``KERNEL_D``),
goes through ``kernels.attention.flash_attention`` (K2 forward, K3
backward; D = 384 / 8 = 48 in the listener VQ, 768 / 8 = 96 in the speaker
VQ), the counterpart of the JAX package's Pallas route
(``ops/transformer.py:98-103``); every other attention, any other head
width included, is a plain ``torch.matmul`` + softmax (``attend``). The JAX
package's window, 512 <= L <= 1024, was set by TPU timings: the port keeps
its lower edge, which the H100's timings of the two routes bear out (see
``FLASH_MIN_LEN``), and drops the upper one, since K2/K3 take any L.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import KERNEL_D, flash_attention

# Shortest sequence that takes K2/K3, in fp32 and bf16: the JAX package's
# lower edge, which the two routes' times on an H100 at 700 W keep (forward
# + backward at 8 rows; chip_smoke.py vq_attention_routes, PERF.md §6). VQ
# training pads clips to powers of two. At 256 the matmul route leads or
# ties; at 1024 K2/K3 lead in both dtypes and at both VQ head widths; at 512
# they lead in bf16 and in fp32 at the listener VQ's D = 48, and trail 1.48x
# only in fp32 at the speaker VQ's D = 96, which trains on 1024-frame clips
# and cannot train on the reference's files (ROADMAP.md queue 3).
FLASH_MIN_LEN = 512


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.reshape(b, n, heads, d // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def attend(q, k, v, scale: float, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, L, D), scores in fp32; ``mask``
    broadcasts to (B, H, Lq, Lk), True = keep."""
    dots = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if mask is not None:
        dots = dots.masked_fill(~mask, float("-inf"))
    attn = torch.softmax(dots, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


class Attention(nn.Module):
    """Fused qkv projection without bias; output projection with bias."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.scale = dim ** -0.5  # full-width scale, reference quirk
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask: (Lq, Lk) or (B, Lq, Lk) (a (B, 1, Lk) key mask broadcasts)."""
        q, k, v = (split_heads(t, self.heads)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        key_mask = mask[:, 0] if mask is not None and mask.dim() == 3 and mask.shape[1] == 1 \
            else None
        if ((mask is None or key_mask is not None) and k.shape[2] >= FLASH_MIN_LEN
                and k.shape[3] in KERNEL_D):
            return self.to_out(self._flash(q, k, v, key_mask))
        if mask is not None:
            mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
        return self.to_out(merge_heads(attend(q, k, v, self.scale, mask)))

    def _flash(self, q, k, v, key_mask) -> torch.Tensor:
        """(B, H, L, D) q, k, v as (B·H, L, D) rows, a (B, L) key mask shared
        by each sample's H rows -> (B, L, H·D)."""
        b, h, n, d = q.shape
        rows = [t.reshape(b * h, n, d).contiguous() for t in (q, k, v)]
        km = None if key_mask is None else key_mask.to(torch.bool).contiguous()
        out = flash_attention(*rows, km, causal=False, scale=self.scale)
        return merge_heads(out.reshape(b, h, n, d))


class CrossModalAttention(nn.Module):
    """Q from modality a, K/V from modality b (base_models.py:62-107): a
    fused unbiased ``to_kv`` on b, an unbiased ``to_q`` on a, a biased
    ``to_out``, the full-width scale."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.scale = dim ** -0.5
        self.to_kv = nn.Linear(dim, dim * 2, bias=False)
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x_a: torch.Tensor, x_b: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask: (Lq, Lk) or (B, Lq, Lk), True = keep."""
        k, v = (split_heads(t, self.heads) for t in self.to_kv(x_b).chunk(2, dim=-1))
        q = split_heads(self.to_q(x_a), self.heads)
        if mask is not None:
            mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
        return self.to_out(merge_heads(attend(q, k, v, self.scale, mask)))


class MLP(nn.Module):
    """Linear -> tanh-GELU -> Linear."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.l1 = nn.Linear(dim, hidden_dim)
        self.l2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l2(F.gelu(self.l1(x), approximate="tanh"))


class _PreNorm(nn.Module):
    """Norm then ``fn`` (base_models.py:9-23), LayerNorm eps 1e-5."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x, *args):
        return self.fn(self.norm(x), *args)


class _CrossPreNorm(_PreNorm):
    """Norm of the K/V stream, then ``fn(context, normed, mask)``: the
    query stream is not normed (base_models.py:17-20)."""

    def forward(self, x, mask=None, context=None):
        return self.fn(context, self.norm(x), mask)


class _Residual(nn.Module):
    """x + fn(x) (base_models.py:26-40)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, *args):
        return x + self.fn(x, *args)


class Transformer(nn.Module):
    """Stack of pre-norm (attention, MLP) pairs, no final norm
    (base_models.py:149-199). With ``cross_modal`` each attention is a
    ``CrossModalAttention`` whose queries come from the fixed ``context``
    (reference ``x_a``) and whose keys and values come from the stream being
    updated (the JAX package's ``TransformerBlock(cross_modal=True)``)."""

    def __init__(self, hidden_size: int, num_hidden_layers: int,
                 num_attention_heads: int, intermediate_size: int,
                 cross_modal: bool = False):
        super().__init__()
        self.cross_modal = cross_modal
        self.net = nn.ModuleList()
        for _ in range(num_hidden_layers):
            attn = (_CrossPreNorm(hidden_size, CrossModalAttention(hidden_size,
                                                                   num_attention_heads))
                    if cross_modal else
                    _PreNorm(hidden_size, Attention(hidden_size, num_attention_heads)))
            self.net.append(_Residual(attn))
            self.net.append(_Residual(_PreNorm(
                hidden_size, MLP(hidden_size, intermediate_size))))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        for attn, mlp in zip(self.net[0::2], self.net[1::2]):
            x = mlp(attn(x, mask, context) if self.cross_modal else attn(x, mask))
        return x


class LinearEmbedding(nn.Module):
    """Single linear layer (base_models.py:202-210)."""

    def __init__(self, dim_in: int, dim: int):
        super().__init__()
        self.net = nn.Linear(dim_in, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class AudioEmbedding(nn.Module):
    """Audio max-pool squasher and projection (base_models.py:213-246,
    'v6'): (B, C, L) -> MaxPool(4), then max(quant_factor, 1) MaxPool(2)
    over time, then ``proj`` C -> dim; returns (B, dim, L')."""

    def __init__(self, size: int, dim: int, quant_factor: int):
        super().__init__()
        self.quant_factor = quant_factor
        self.proj = nn.Linear(size, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from .convseq import max_pool_time

        h = max_pool_time(x.transpose(1, 2), 4)
        for _ in range(max(self.quant_factor, 1)):
            h = max_pool_time(h, 2)
        return self.proj(h).transpose(1, 2)


class CrossModalLayer(nn.Module):
    """FACT's cross-modal layer (base_models.py:276-328): the two streams
    concatenated over time, a learned (zero-initialised) position embedding,
    a ``Transformer``, LayerNorm (eps 1e-5) and an unbiased output
    projection."""

    def __init__(self, in_dim: int, out_dim: int, sequence_length: int,
                 num_hidden_layers: int = 2, num_attention_heads: int = 8,
                 intermediate_size: int = 256):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.zeros(sequence_length, in_dim))
        self.transformer_layer = Transformer(in_dim, num_hidden_layers,
                                             num_attention_heads, intermediate_size)
        self.cross_norm_layer = nn.LayerNorm(in_dim, eps=1e-5)
        self.cross_output_layer = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, modal_a: torch.Tensor, modal_b: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        merged = modal_a
        if modal_b is not None:
            if modal_a.shape[-1] != modal_b.shape[-1]:
                raise ValueError("modal_a and modal_b hidden sizes must match "
                                 "(base_models.py:317-320)")
            merged = torch.cat([modal_a, modal_b], dim=1)
        merged = merged + self.pos_embedding[: merged.shape[1]].to(merged.dtype)[None]
        merged = self.transformer_layer(merged, mask)
        return self.cross_output_layer(self.cross_norm_layer(merged))
