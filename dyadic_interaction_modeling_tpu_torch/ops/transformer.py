"""Pre-norm transformer blocks of the VQ-VAEs (base_models.py:9-210).

Counterpart of ``dyadic_interaction_modeling_tpu/ops/transformer.py:49-214``.
Module keys follow the reference: ``net.{2j}.fn.norm`` / ``net.{2j}.fn.fn``
(Residual(Norm(Attention))) and ``net.{2j+1}.fn.norm`` / ``net.{2j+1}.fn.fn``
(Residual(Norm(MLP))); the JAX package's ``TransformerBlock`` is the pair
``net.{2j}``, ``net.{2j+1}``.

Reproduced reference quirks:

* the attention scale is ``hidden_size ** -0.5``, the full width, not the
  per-head width;
* GELU is the tanh approximation;
* LayerNorm eps is 1e-5.

Attention over L >= ``FLASH_MIN_LEN`` keys without a mask, or with only a
(B, 1, Lk) key mask, goes through ``kernels.attention.flash_attention`` (K2
forward, K3 backward; D = 384 / 8 = 48 at full width), the counterpart of
the JAX package's Pallas route (``ops/transformer.py:98-103``); every other
attention is a plain ``torch.matmul`` + softmax (``attend``). The JAX
package's window, 512 <= L <= 1024, was set by TPU timings: the port keeps
its lower edge as a starting point and drops the upper one, since K2/K3 take
any L.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import flash_attention

# shortest sequence that takes K2/K3 (the JAX package's lower edge; not yet
# set from H100 timings)
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
        if (mask is None or key_mask is not None) and k.shape[2] >= FLASH_MIN_LEN:
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


class _Residual(nn.Module):
    """x + fn(x) (base_models.py:26-40)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, *args):
        return x + self.fn(x, *args)


class Transformer(nn.Module):
    """Stack of pre-norm (attention, MLP) pairs, no final norm
    (base_models.py:149-199)."""

    def __init__(self, hidden_size: int, num_hidden_layers: int,
                 num_attention_heads: int, intermediate_size: int):
        super().__init__()
        self.net = nn.ModuleList()
        for _ in range(num_hidden_layers):
            self.net.append(_Residual(_PreNorm(
                hidden_size, Attention(hidden_size, num_attention_heads))))
            self.net.append(_Residual(_PreNorm(
                hidden_size, MLP(hidden_size, intermediate_size))))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for attn, mlp in zip(self.net[0::2], self.net[1::2]):
            x = mlp(attn(x, mask))
        return x


class LinearEmbedding(nn.Module):
    """Single linear layer (base_models.py:202-210)."""

    def __init__(self, dim_in: int, dim: int):
        super().__init__()
        self.net = nn.Linear(dim_in, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)
