"""x-transformers stack of the SLM family, with cached decoding.

Counterpart of ``dyadic_interaction_modeling_tpu/models/xtrans.py:113-786``:
pre-norm attention layers with separate unbiased q/k/v/out projections,
exact-GELU feedforward (mult 4), scale-only LayerNorm (eps 1e-6, as flax),
learned absolute positions, and KV-cached token generation with top-k
sampling.

Module keys follow x-transformers 1.30: ``layers.{n}.0.0`` is a layer's
pre-norm (``gamma`` parameter, ``beta`` zero buffer), ``layers.{n}.1`` its
attention or feedforward block, ``ff.0.0`` / ``ff.3`` the feedforward
linears, ``pos_emb.emb.weight`` the position table (applied times
``dim ** -0.5``), ``token_emb.emb.weight`` the token table.

The per-token attention of the decode loop (``step_self``, ``step_cross``)
goes through ``kernels.decode.decode_attention`` (K1), and a self-attention
without an ``attn_mask`` through ``kernels.attention.flash_attention`` (K2
forward, K3 backward), whatever its length: the JAX package's
512 <= L <= 2048 window (``xtrans.py:54``) is a TPU timing gate. Both run
their CUDA kernels on the card and their plain versions on the CPU. Each
takes only the head widths its kernels are built for (``KERNEL_D`` of
``kernels/decode.py`` and ``kernels/attention.py``); any other ``dim_head``
takes the dense path on every device, as the JAX package routes widths its
kernels lack (``xtrans.py:54``, ``:101``). A decode step with more query rows
a cache row than K1 takes (``MAX_NQ``; G = heads / kv_heads, times N in
``step_cross``) runs K1 on slices of its rows, which are independent.
Every other attention (cross-attention, a self-attention with an
``attn_mask``, the streaming chunk extension ``extend_self``) is a plain
``torch.matmul`` + softmax, as the JAX package's dense path.

Streaming (``serving/``): ``extend`` runs a chunk causally against KV
caches (``xtrans.py:274``, ``:417``, ``:565``), and every cached step takes
its position as an int or as a (B,) tensor of each row's own, which a pool
of sessions at different lengths gives K1 as a key mask.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import KERNEL_D as FLASH_D
from ..kernels.attention import flash_attention
from ..kernels.decode import KERNEL_D as DECODE_D
from ..kernels.decode import MAX_NQ, decode_attention, decode_attention_plain

NEG_INF = float("-inf")
IGNORE = -100  # the ignore_index of token targets


def per_row(t) -> bool:
    """Whether a step position ``t`` is a (B,) tensor of each row's own
    position (a pool of sessions at different lengths) rather than one int
    for the batch."""
    return isinstance(t, torch.Tensor) and t.dim() == 1


def decode_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t=None,
                key_mask: Optional[torch.Tensor] = None, *, scale: float) -> torch.Tensor:
    """``decode_attention`` at any number of query rows a cache row (the JAX
    package has no limit): past K1's ``MAX_NQ`` the rows, which are
    independent, go to K1 in equal slices of at most ``MAX_NQ``."""
    nq = q.shape[1]
    if nq <= MAX_NQ:
        return decode_attention(q, k, v, t, key_mask, scale=scale)
    width = -(-nq // -(-nq // MAX_NQ))
    return torch.cat([decode_attention(qs.contiguous(), k, v, t, key_mask, scale=scale)
                      for qs in q.split(width, dim=1)], dim=1)


class XTNorm(nn.Module):
    """x-transformers 1.30 LayerNorm: ``gamma`` parameter, ``beta`` zero
    buffer, eps 1e-6 (flax's default, which the JAX package uses)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.register_buffer("beta", torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.gamma.to(x.dtype),
                            self.beta.to(x.dtype), self.eps)


class XAttention(nn.Module):
    """Attention with per-head scale and no biases.

    ``kv_heads`` (grouped-query attention): K/V have ``kv_heads`` heads; KV
    head j serves query heads [j*G, (j+1)*G), G = heads // kv_heads.
    """

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 causal: bool = False, kv_heads: Optional[int] = None):
        super().__init__()
        kvh = kv_heads or heads
        if heads % kvh:
            raise ValueError(f"attn_kv_heads={kvh} must divide the head count "
                             f"{heads}")
        self.heads, self.kvh, self.dim_head, self.causal = heads, kvh, dim_head, causal
        self.group = heads // kvh
        self.scale = dim_head ** -0.5
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, kvh * dim_head, bias=False)
        self.to_v = nn.Linear(dim, kvh * dim_head, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def _split(self, x: torch.Tensor, h: int) -> torch.Tensor:
        b, n, _ = x.shape
        return x.reshape(b, n, h, self.dim_head).transpose(1, 2)

    def _fold_q(self, q: torch.Tensor) -> torch.Tensor:
        """(B, H, N, D) -> (B, KVH, G*N, D): query head h = kv_head * G + g,
        rows (G, N)-major."""
        b, _, n, d = q.shape
        return q.reshape(b, self.kvh, self.group * n, d)

    def _merge(self, out: torch.Tensor, n: int) -> torch.Tensor:
        """(B, KVH, G*N, D) -> (B, N, H*D)."""
        b = out.shape[0]
        return out.reshape(b, self.heads, n, self.dim_head).transpose(1, 2).reshape(
            b, n, self.heads * self.dim_head)

    def _flash_attend(self, q, k, v, key_mask) -> torch.Tensor:
        """(B, H, L, D) q and (B, KVH, L, D) k, v -> (B, L, H*D). Under
        kv_heads K/V are repeated to full heads first, as the JAX flash path
        does (``xtrans.py:191-192``); autograd sums their gradients."""
        b, h, n, d = q.shape
        if self.group > 1:
            k = k.repeat_interleave(self.group, dim=1)
            v = v.repeat_interleave(self.group, dim=1)
        km = None if key_mask is None else key_mask.to(torch.bool).contiguous()
        out = flash_attention(q.reshape(b * h, n, d).contiguous(),
                              k.reshape(b * h, n, d).contiguous(),
                              v.reshape(b * h, n, d).contiguous(), km,
                              causal=self.causal, scale=self.scale)
        return out.reshape(b, h, n, d).transpose(1, 2).reshape(b, n, h * d)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """key_mask: (B, Lk) True = attend; attn_mask: (Lq, Lk) or (B, Lq, Lk)."""
        kv_src = x if context is None else context
        q = self._split(self.to_q(x), self.heads)
        k = self._split(self.to_k(kv_src), self.kvh)
        v = self._split(self.to_v(kv_src), self.kvh)
        if context is None and attn_mask is None and self.dim_head in FLASH_D:
            return self.to_out(self._flash_attend(q, k, v, key_mask))
        nq, g = q.shape[2], self.group
        dots = torch.matmul(self._fold_q(q), k.transpose(-1, -2)).float() * self.scale
        lk = dots.shape[-1]
        keep = None
        if self.causal:
            keep = torch.ones(nq, lk, dtype=torch.bool, device=x.device).tril(lk - nq)
            keep = keep.repeat(g, 1)[None, None]
        if attn_mask is not None:
            am = (attn_mask.repeat(g, 1)[None, None] if attn_mask.dim() == 2
                  else attn_mask.repeat(1, g, 1)[:, None])
            keep = am if keep is None else keep & am
        if key_mask is not None:
            km = key_mask[:, None, None, :]
            keep = km if keep is None else keep & km
        if keep is not None:
            dots = dots.masked_fill(~keep, NEG_INF)
        attn = torch.softmax(dots, dim=-1)
        # fully masked rows (padding queries) give zeros, not NaN
        attn = torch.where(torch.isfinite(dots).any(dim=-1, keepdim=True), attn,
                           torch.zeros((), device=x.device))
        out = torch.matmul(attn.to(v.dtype), v)
        return self.to_out(self._merge(out, nq))

    # --- cached single-step path (generation) ---

    @staticmethod
    def _step_attention(dh: int):
        """K1 at the head widths it is built for, else the dense step."""
        return decode_rows if dh in DECODE_D else decode_attention_plain

    def cross_kv(self, context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K/V of a context, computed once per generation:
        (B, KVH, L, Dh) each."""
        return (self._split(self.to_k(context), self.kvh).contiguous(),
                self._split(self.to_v(context), self.kvh).contiguous())

    def step_self(self, x_t: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, t) -> torch.Tensor:
        """One causal token against the KV cache, which is updated IN PLACE
        at position ``t`` (the JAX package returns a new cache instead).

        x_t: (B, 1, dim); cache_k/v: (B, KVH, Lmax, Dh); t: int step index,
        or a (B,) tensor of each row's own index (a pool of sessions at
        different lengths): then each row's K/V are written at its index and
        its bound goes to K1 as a (B, Lmax) key mask ``pos <= t[b]``.
        """
        b = x_t.shape[0]
        _, kvh, lmax, dh = cache_k.shape
        k_t = self.to_k(x_t).reshape(b, kvh, dh)
        v_t = self.to_v(x_t).reshape(b, kvh, dh)
        key_mask = None
        if per_row(t):
            rows = torch.arange(b, device=t.device)
            cache_k[rows, :, t] = k_t
            cache_v[rows, :, t] = v_t
            key_mask = torch.arange(lmax, device=t.device)[None, :] <= t[:, None]
            t = None
        else:
            cache_k[:, :, t] = k_t
            cache_v[:, :, t] = v_t
        # (B, 1, H*Dh) is (B, KVH, G, Dh) row-major: the folded query rows
        q = self.to_q(x_t).reshape(b * kvh, self.group, dh)
        attend = self._step_attention(dh)
        o = attend(q, cache_k.view(b * kvh, lmax, dh), cache_v.view(b * kvh, lmax, dh), t,
                   key_mask, scale=self.scale)
        return self.to_out(o.reshape(b, 1, self.heads * dh))

    def extend_self(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                    t) -> torch.Tensor:
        """A causal chunk against the KV cache (streaming prefill,
        ``xtrans.py:274`` of the JAX package): the chunk's K/V are written IN
        PLACE at [t, t+C), and its C queries attend causally to cache[:t+C].
        Equal to rows [t, t+C) of the causal forward over the whole sequence.
        ``t``: int, or a (B,) tensor of each row's own start. Dense, as in
        the JAX package: K2 takes no causal window at an offset.

        x: (B, C, dim); cache_k/v: (B, KVH, Lmax, Dh). Returns (B, C, dim).
        """
        b, c, _ = x.shape
        lmax = cache_k.shape[2]
        q = self._split(self.to_q(x), self.heads)
        k_c = self._split(self.to_k(x), self.kvh)
        v_c = self._split(self.to_v(x), self.kvh)
        steps = torch.arange(c, device=x.device)
        if per_row(t):
            qpos = t[:, None] + steps                            # (B, C)
            rows = torch.arange(b, device=x.device)[:, None]
            cache_k[rows, :, qpos] = k_c.transpose(1, 2)
            cache_v[rows, :, qpos] = v_c.transpose(1, 2)
        else:
            qpos = (int(t) + steps)[None]                        # (1, C)
            cache_k[:, :, int(t): int(t) + c] = k_c
            cache_v[:, :, int(t): int(t) + c] = v_c
        dots = torch.matmul(self._fold_q(q), cache_k.transpose(-1, -2)).float() * self.scale
        keep = torch.arange(lmax, device=x.device)[None, None, :] <= qpos[:, :, None]
        dots = dots.masked_fill(~keep.repeat(1, self.group, 1)[:, None], NEG_INF)
        attn = torch.softmax(dots, dim=-1)
        out = torch.matmul(attn.to(cache_v.dtype), cache_v)
        return self.to_out(self._merge(out, c))

    def step_cross(self, x_t: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: Optional[torch.Tensor], groups: int = 1) -> torch.Tensor:
        """One token against precomputed context K/V.

        ``groups > 1``: best-of-N shares one context across N samples.
        ``x_t`` has N*B0 rows (sample-major) while k/v/key_mask carry B0 rows;
        the N queries of a context attend as N query rows over one K/V read.
        """
        nb = x_t.shape[0]
        b0, kvh, lk, dh = k.shape
        n = nb // b0
        if n != groups:
            raise ValueError(f"step_cross: {nb} query rows for {b0} contexts "
                             f"and groups={groups}")
        q = self.to_q(x_t).reshape(n, b0, self.heads, dh).permute(1, 2, 0, 3)
        q = q.reshape(b0 * kvh, self.group * n, dh).contiguous()
        attend = self._step_attention(dh)
        o = attend(q, k.view(b0 * kvh, lk, dh), v.view(b0 * kvh, lk, dh), None, key_mask,
                   scale=self.scale)
        # (B0*KVH, G*N, Dh) -> (B0, H, N, Dh) -> (N*B0, 1, H*Dh)
        o = o.reshape(b0, self.heads, n, dh).permute(2, 0, 1, 3)
        return self.to_out(o.reshape(nb, 1, self.heads * dh))


class FeedForward(nn.Module):
    """Linear -> exact GELU -> Linear, keyed ``ff.0.0`` / ``ff.3``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.ff = nn.Sequential(nn.Sequential(nn.Linear(dim, dim * mult), nn.GELU()),
                                nn.Identity(), nn.Identity(),
                                nn.Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff(x)


def _layer(dim: int, block: nn.Module) -> nn.ModuleList:
    """An x-transformers layer: [[norm], block] (the residual has no params)."""
    return nn.ModuleList([nn.ModuleList([XTNorm(dim)]), block])


class EncoderLayers(nn.Module):
    """Pre-norm (self-attn, ff) x depth + final norm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int = 64,
                 kv_heads: Optional[int] = None):
        super().__init__()
        self.depth = depth
        layers = []
        for _ in range(depth):
            layers.append(_layer(dim, XAttention(dim, heads, dim_head,
                                                 kv_heads=kv_heads)))
            layers.append(_layer(dim, FeedForward(dim)))
        self.layers = nn.ModuleList(layers)
        self.final_norm = XTNorm(dim)

    def forward(self, x, key_mask=None, attn_mask=None):
        for i in range(self.depth):
            (norm_a,), attn = self.layers[2 * i]
            (norm_f,), ff = self.layers[2 * i + 1]
            x = x + attn(norm_a(x), key_mask=key_mask, attn_mask=attn_mask)
            x = x + ff(norm_f(x))
        return self.final_norm(x)

    def extend(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], t) -> torch.Tensor:
        """A (B, C, dim) chunk causally against per-layer KV caches (the
        layout of ``init_decoder_cache``), updated in place: rows [t, t+C) of
        the causal forward over the whole sequence."""
        for i in range(self.depth):
            (norm_a,), attn = self.layers[2 * i]
            (norm_f,), ff = self.layers[2 * i + 1]
            x = x + attn.extend_self(norm_a(x), cache[f"k_{i}"], cache[f"v_{i}"], t)
            x = x + ff(norm_f(x))
        return self.final_norm(x)


class DecoderLayers(nn.Module):
    """Pre-norm (causal self-attn, cross-attn, ff) x depth + final norm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int = 64,
                 kv_heads: Optional[int] = None):
        super().__init__()
        self.depth = depth
        layers = []
        for _ in range(depth):
            layers.append(_layer(dim, XAttention(dim, heads, dim_head, causal=True,
                                                 kv_heads=kv_heads)))
            layers.append(_layer(dim, XAttention(dim, heads, dim_head,
                                                 kv_heads=kv_heads)))
            layers.append(_layer(dim, FeedForward(dim)))
        self.layers = nn.ModuleList(layers)
        self.final_norm = XTNorm(dim)

    def _blocks(self, i: int):
        return self.layers[3 * i], self.layers[3 * i + 1], self.layers[3 * i + 2]

    def forward(self, x, context=None, self_key_mask=None, context_mask=None):
        for i in range(self.depth):
            ((ns,), sa), ((nc,), ca), ((nf,), ff) = self._blocks(i)
            x = x + sa(ns(x), key_mask=self_key_mask)
            x = x + ca(nc(x), context=context, key_mask=context_mask)
            x = x + ff(nf(x))
        return self.final_norm(x)

    def cross_kv(self, context: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [self._blocks(i)[1][1].cross_kv(context) for i in range(self.depth)]

    def step(self, x_t: torch.Tensor, cache: Dict[str, torch.Tensor], t,
             cross_kv: List[Tuple[torch.Tensor, torch.Tensor]],
             context_mask: Optional[torch.Tensor] = None, cross_groups: int = 1
             ) -> torch.Tensor:
        for i in range(self.depth):
            ((ns,), sa), ((nc,), ca), ((nf,), ff) = self._blocks(i)
            x_t = x_t + sa.step_self(ns(x_t), cache[f"k_{i}"], cache[f"v_{i}"], t)
            k, v = cross_kv[i]
            x_t = x_t + ca.step_cross(nc(x_t), k, v, context_mask, cross_groups)
            x_t = x_t + ff(nf(x_t))
        return self.final_norm(x_t)


def init_decoder_cache(batch: int, max_len: int, depth: int, heads: int,
                       dim_head: int = 64, dtype=torch.float32,
                       kv_heads: Optional[int] = None,
                       device=None) -> Dict[str, torch.Tensor]:
    """Preallocated self-attention KV cache for ``DecoderLayers.step``:
    (batch, kv_heads or heads, max_len, dim_head) per layer and K/V."""
    shape = (batch, kv_heads or heads, max_len, dim_head)
    cache = {}
    for i in range(depth):
        cache[f"k_{i}"] = torch.zeros(shape, dtype=dtype, device=device)
        cache[f"v_{i}"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


class _Embedding(nn.Module):
    """x-transformers' embedding wrapper (``.emb`` holds the table)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.emb = nn.Embedding(num, dim)
        nn.init.normal_(self.emb.weight, std=0.02)


class ContinuousTransformerWrapper(nn.Module):
    """project_in -> + learned abs pos emb -> encoder layers [-> project_out].

    Without ``dim_out`` it is the ``return_embeddings=True`` use of
    x-transformers' wrapper, which the SLM family and the seq2seq encoders
    make: there is no ``project_out``, as the JAX package never creates that
    parameter for such encoders. With ``dim_out`` (``ContinuousSeq2Seq``'s
    decoder) the embeddings go through ``project_out``."""

    def __init__(self, dim_in: int, dim: int, max_seq_len: int, depth: int,
                 heads: int, dim_head: int = 64, kv_heads: Optional[int] = None,
                 dim_out: Optional[int] = None):
        super().__init__()
        self.scale = dim ** -0.5
        self.project_in = nn.Linear(dim_in, dim)
        self.pos_emb = _Embedding(max_seq_len, dim)
        self.attn_layers = EncoderLayers(dim, depth, heads, dim_head, kv_heads)
        if dim_out is not None:
            self.project_out = nn.Linear(dim, dim_out)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.project_in(x)
        h = h + (self.pos_emb.emb.weight[: h.shape[1]] * self.scale).to(h.dtype)[None]
        h = self.attn_layers(h, key_mask=mask, attn_mask=attn_mask)
        return self.project_out(h) if hasattr(self, "project_out") else h

    def extend(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], t) -> torch.Tensor:
        """Streaming causal extension (``xtrans.py:565`` of the JAX package):
        a (B, C, dim_in) chunk whose first frame sits at absolute position
        ``t`` (an int, or a (B,) tensor of each row's own), against per-layer
        KV caches updated in place. Returns the embeddings. Valid only for
        encoders used causally (SLMFT's, under a triangular attn_mask). The
        positions are the table's rows [t, t+C), the start clamped to the
        table as ``lax.dynamic_slice`` clamps it."""
        h = self.project_in(x)
        c, table = h.shape[1], self.pos_emb.emb.weight
        if per_row(t):
            start = t.clamp(max=table.shape[0] - c)
            pos = table[start[:, None] + torch.arange(c, device=t.device)]
        else:
            start = min(int(t), table.shape[0] - c)
            pos = table[start: start + c][None]
        h = h + (pos * self.scale).to(h.dtype)
        return self.attn_layers.extend(h, cache, t)


class TokenDecoder(nn.Module):
    """Token embedding [+ learned abs pos emb] -> decoder layers -> logits."""

    def __init__(self, num_tokens: int, dim: int, max_seq_len: int, depth: int,
                 heads: int, dim_head: int = 64, use_abs_pos_emb: bool = True,
                 kv_heads: Optional[int] = None):
        super().__init__()
        self.depth, self.heads, self.dim_head = depth, heads, dim_head
        self.kv_heads = kv_heads
        self.scale = dim ** -0.5
        self.token_emb = _Embedding(num_tokens, dim)
        if use_abs_pos_emb:
            self.pos_emb = _Embedding(max_seq_len, dim)
        self.attn_layers = DecoderLayers(dim, depth, heads, dim_head, kv_heads)
        self.to_logits = nn.Linear(dim, num_tokens, bias=False)

    def _embed(self, tokens: torch.Tensor, offset=0) -> torch.Tensor:
        """Token and position embeddings; ``offset`` is an int, or a (B,)
        tensor of each row's own first position."""
        emb = self.token_emb.emb(tokens.long())
        if hasattr(self, "pos_emb"):
            table = self.pos_emb.emb.weight
            if per_row(offset):
                pos = table[offset[:, None] + torch.arange(tokens.shape[1],
                                                           device=offset.device)]
            else:
                pos = table[offset: offset + tokens.shape[1]][None]
            emb = emb + (pos * self.scale).to(emb.dtype)
        return emb

    def forward(self, tokens, context=None, self_key_mask=None, context_mask=None):
        h = self._embed(tokens)
        h = self.attn_layers(h, context=context, self_key_mask=self_key_mask,
                             context_mask=context_mask)
        return self.to_logits(h)

    def cross_kv(self, context: torch.Tensor):
        return self.attn_layers.cross_kv(context)

    def decode_step(self, token: torch.Tensor, cache, t, cross_kv,
                    context_mask: Optional[torch.Tensor] = None,
                    cross_groups: int = 1) -> torch.Tensor:
        """token (B, 1) at position ``t`` (an int, or a (B,) tensor of each
        row's own, see ``XAttention.step_self``) -> logits (B, num_tokens);
        writes the token's K/V into ``cache`` in place."""
        h = self._embed(token, t)
        h = self.attn_layers.step(h, cache, t, cross_kv, context_mask, cross_groups)
        return self.to_logits(h)[:, 0]


def ar_inputs_targets(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted teacher-forcing split (AutoregressiveWrapper.forward):
    inputs ``x[:, :-1]`` with ignored (-100) positions set to 0, targets
    ``x[:, 1:]``."""
    inp, target = x[:, :-1], x[:, 1:]
    return torch.where(inp == IGNORE, 0, inp), target


def ar_mask_prob_kv_mask(batch: int, seq: int, mask_prob: float,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> torch.Tensor:
    """The AutoregressiveWrapper's ``mask_prob`` input corruption as a
    self-attention key mask (B, seq), True = attend: the
    ``floor(seq * mask_prob)`` positions of largest standard-normal ``noise``
    in each row are masked, never position 0. ``noise`` (B, seq) is injected
    or drawn from ``generator``, so a test can feed the JAX package's
    ``jax.random.normal`` draw."""
    num_mask = min(int(seq * mask_prob), seq - 1)
    if noise is not None:
        device = noise.device
    keep = torch.ones(batch, seq, dtype=torch.bool, device=device)
    if num_mask <= 0:
        return keep
    if noise is None:
        noise = torch.randn(batch, seq, generator=generator, device=device)
    rand = noise.float().clone()
    rand[:, 0] = NEG_INF
    return keep.scatter(1, rand.topk(num_mask, dim=1).indices, False)


def ar_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token CE in fp32, mean over the targets that are not -100; 0 when
    none is kept (where ``F.cross_entropy(ignore_index=-100)`` gives NaN)."""
    v = logits.shape[-1]
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, targets.clamp(0, v - 1).long()[..., None])[..., 0]
    keep = (targets != IGNORE).float()
    return (nll * keep).sum() / keep.sum().clamp_min(1.0)


def top_k_filter(logits: torch.Tensor, frac_num_tokens: float = 0.1) -> torch.Tensor:
    """x-transformers ``top_k``: keep the ceil(frac * vocab) best logits,
    ties at the k-th included."""
    k = max(1, math.ceil(frac_num_tokens * logits.shape[-1]))
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """-log(-log(U)), U uniform on [tiny, 1), the noise of
    ``jax.random.categorical``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, greedy: bool = False, temperature: float = 1.0,
                  filter_frac: float = 0.1, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The next tokens from (B, vocab) logits, in fp32: their argmax when
    ``greedy``, else ``top_k_filter(logits, filter_frac) / temperature``
    sampled as Gumbel-max (``jax.random.categorical``, ``xtrans.py:700-705``
    of the JAX package), with the (B, vocab) Gumbel ``noise`` injected or
    drawn from ``generator``."""
    lg = logits.float()
    if greedy:
        return lg.argmax(dim=-1)
    filt = top_k_filter(lg, filter_frac) / temperature
    if noise is None:
        noise = gumbel_noise(filt.shape, generator, filt.device)
    return (filt + noise.to(filt.device)).argmax(dim=-1)


@torch.no_grad()
def generate_tokens(decoder: TokenDecoder, prompt: torch.Tensor, seq_len: int,
                    context: torch.Tensor, context_mask: Optional[torch.Tensor],
                    generator: Optional[torch.Generator] = None,
                    greedy: bool = False, context_groups: int = 1,
                    gumbel: Optional[torch.Tensor] = None, temperature: float = 1.0,
                    filter_frac: float = 0.1) -> torch.Tensor:
    """KV-cached autoregressive sampling: (B, seq_len) generated tokens.

    Cross K/V are computed once, then one cached ``decode_step`` per token.
    Sampling (``sample_tokens``) follows the reference defaults: top-k
    keep-``filter_frac`` (10%) filtering, ``temperature`` 1.0, categorical
    sampling as Gumbel-max in fp32. ``gumbel`` (seq_len, B, vocab) injects
    the noise (then ``generator`` is unused), so a sampled stream can be held
    token-exact against another implementation fed the same noise.
    ``prompt`` (B, P) is consumed through the cache and not returned.

    ``context_groups``: best-of-N sharing - ``prompt`` has N*B0 rows
    (sample-major) while ``context`` / ``context_mask`` carry the B0 distinct
    rows. Step ``t`` reads only the t+1 live cache entries (K1 is bounded by
    t), so there is no chunked-prefix schedule as in the JAX package.
    """
    b, p = prompt.shape
    if b % context_groups:
        raise ValueError(f"batch {b} is not a multiple of context_groups "
                         f"{context_groups}")
    dtype = decoder.to_logits.weight.dtype
    device = prompt.device
    cross = decoder.cross_kv(context.to(dtype))
    mask = None if context_mask is None else context_mask.to(torch.bool).contiguous()
    cache = init_decoder_cache(b, p + seq_len, decoder.depth, decoder.heads,
                               decoder.dim_head, dtype, decoder.kv_heads, device)
    logits = None
    for i in range(p):
        logits = decoder.decode_step(prompt[:, i: i + 1], cache, i, cross, mask,
                                     context_groups)
    tokens = torch.empty(b, seq_len, dtype=prompt.dtype, device=device)
    for i in range(seq_len):
        tok = sample_tokens(logits, greedy, temperature, filter_frac,
                            None if gumbel is None else gumbel[i], generator)
        tokens[:, i] = tok.to(prompt.dtype)
        if i + 1 < seq_len:  # the last token's logits would go unused
            logits = decoder.decode_step(tokens[:, i: i + 1], cache, p + i, cross,
                                         mask, context_groups)
    return tokens
