"""DeepSeek-V2 decoder (arXiv:2405.04434; ``modeling_deepseek.py`` of the
published checkpoints) on the port's token generator.

A context-free decoder: token embedding, ``num_hidden_layers`` pre-norm
layers of multi-head latent attention (MLA) and a SwiGLU feedforward (dense
in the first ``first_k_dense_replace`` layers, then a mixture of experts with
shared experts), a final RMSNorm and an untied head. It brings what
``models/xtrans.generate_tokens`` asks of a decoder: ``init_cache``,
``prefill``, ``decode_step`` and ``head``.

* MLA without a q LoRA. Keys and values come from a 512-wide latent ``c``
  (``kv_a_proj_with_mqa``, then ``kv_a_layernorm`` on the latent dims only)
  and one 64-wide rope key shared by the heads. The full form (``forward``,
  ``prefill``) expands ``c`` through ``kv_b_proj`` to per-head 128-wide
  keys and values, q and k 192 = 128 + 64 wide, and runs causal SDPA (v
  padded to 192 with zeros; K2 takes no 192-wide head). The absorbed form
  (``decode_step``) folds W_UK into the queries and applies W_UV after
  attention over the cached latent rows: an MQA step of 16 query rows over
  576-wide keys, the first 512 of which are the values: K5
  (``kernels/latent_decode.py``), which takes the published widths alone on
  the card (any widths on the CPU, its plain version). The cache holds one
  (B, L, 576) row a layer: ``kv_a_layernorm(c)`` || the rope key after
  rotation.
* YaRN rope as DeepSeek applies it: the 64 rope dims permuted from
  interleaved pairs to halves before the rotation (``apply_rotary_pos_emb``),
  inverse frequencies blended between the extrapolated and interpolated ones
  by a linear ramp over [low, high) (``yarn_find_correction_range``), the
  tables times mscale(factor, mscale) / mscale(factor, mscale_all_dim), and
  the softmax scale 192^-0.5 times mscale(factor, mscale_all_dim)^2.
* The router in fp32 (``MoEGate``): softmax scores, the top ``k`` by
  ``greedy`` (ties to the lower expert), weights times
  ``routed_scaling_factor`` (normalised first when ``norm_topk_prob``). The
  routed experts' outputs are weighted and summed in fp32, then cast; the
  shared experts (one SwiGLU of ``n_shared_experts`` times the expert width)
  are added in the model's dtype, as ``moe_infer`` does.
* The expert layer with static shapes: K6 (``kernels/moe_route.py``) routes
  and groups the token-expert pairs by expert with each expert's end, one
  grouped GEMM a projection (``torch._grouped_mm``) runs the experts on the
  card, and K6 combines: no host sync, so it replays inside a CUDA graph; on
  the CPU the plain versions (a stable sort by expert) and a loop over the
  experts' row ranges. A decode step adds each expert's pair count to
  ``expert_load`` on the card.

Spans: ``prefill`` (counter ``tokens``) and one ``moe`` an expert layer a
forward (eager calls only: a graph replays no Python).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.latent_decode import latent_decode
from ..kernels.moe_route import moe_combine, moe_dispatch
from ..utils.profiling import span
from .xtrans import device_step


@dataclass
class DeepseekV2Config:
    """The keys of DeepSeek-V2's ``config.json`` that shape the decoder."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    scoring_func: str = "softmax"
    topk_method: str = "greedy"
    initializer_range: float = 0.006  # the paper's; V2-Lite's config.json leaves it out

    @classmethod
    def from_dict(cls, d: dict) -> "DeepseekV2Config":
        """The known keys of ``d``; the others (``model_type``, ...) are left."""
        cfg = cls(**{f.name: d[f.name] for f in fields(cls) if f.name in d})
        if cfg.q_lora_rank is not None:
            raise ValueError("DeepseekV2Decoder: q_lora_rank is not supported (V2-Lite has none)")
        if cfg.scoring_func != "softmax" or cfg.topk_method != "greedy":
            raise ValueError("DeepseekV2Decoder: only the softmax gate with greedy top-k")
        return cfg

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, i: int) -> bool:
        return i >= self.first_k_dense_replace and i % self.moe_layer_freq == 0


def yarn_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(low_rot: float, high_rot: float, dim: int, base: float,
                          max_pos: int):
    def dim_of(rot):
        return (dim * math.log(max_pos / (rot * 2 * math.pi))) / (2 * math.log(base))

    return max(math.floor(dim_of(low_rot)), 0), min(math.ceil(dim_of(high_rot)), dim - 1)


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """(rope_dim / 2,) fp32 inverse frequencies (``DeepseekV2YarnRotaryEmbedding``;
    plain rope without ``rope_scaling``)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** exps)
    rs = cfg.rope_scaling
    if not rs:
        return extra
    inter = 1.0 / (rs["factor"] * base ** exps)
    low, high = yarn_correction_range(rs.get("beta_fast", 32), rs.get("beta_slow", 1), dim,
                                      base, rs["original_max_position_embeddings"])
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp  # 1: the extrapolated (unscaled) frequency
    return inter * (1 - keep) + extra * keep


def rope_mscale(cfg: DeepseekV2Config) -> float:
    """The factor on the cos / sin tables."""
    rs = cfg.rope_scaling
    if not rs:
        return 1.0
    return (yarn_mscale(rs["factor"], rs.get("mscale", 1))
            / yarn_mscale(rs["factor"], rs.get("mscale_all_dim", 0)))


def softmax_scale(cfg: DeepseekV2Config) -> float:
    scale = cfg.q_head_dim ** -0.5
    rs = cfg.rope_scaling
    if rs and rs.get("mscale_all_dim"):
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def apply_rope(x: torch.Tensor, freqs: torch.Tensor, mscale: float) -> torch.Tensor:
    """DeepSeek's rotation of ``x`` (..., 2n) at ``freqs`` (broadcast to
    (..., n)): the interleaved pairs (x[2i], x[2i+1]) permuted to halves,
    then rotated; computed in fp32, returned in x's dtype."""
    cos, sin = freqs.cos() * mscale, freqs.sin() * mscale
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * xf.to(x.dtype)


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, hidden: int, inter: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, inter, bias=False)
        self.up_proj = nn.Linear(hidden, inter, bias=False)
        self.down_proj = nn.Linear(inter, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Experts(nn.Module):
    """``E`` SwiGLU experts, stacked: ``gate_up_proj`` (E, 2I, H) holds each
    expert's gate rows then its up rows, ``down_proj`` (E, H, I)."""

    def __init__(self, n: int, hidden: int, inter: int):
        super().__init__()
        self.n, self.inter = n, inter
        self.gate_up_proj = nn.Parameter(torch.empty(n, 2 * inter, hidden))
        self.down_proj = nn.Parameter(torch.empty(n, hidden, inter))
        for w in (self.gate_up_proj, self.down_proj):
            nn.init.normal_(w, std=0.02)

    def _swiglu(self, h: torch.Tensor) -> torch.Tensor:
        return F.silu(h[:, : self.inter]) * h[:, self.inter:]

    def grouped(self, xs: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
        """Rows ``xs`` sorted by expert, expert e's rows ending at ``ends[e]``
        (int32, on the rows' device): one grouped GEMM a projection."""
        h = torch._grouped_mm(xs, self.gate_up_proj.transpose(1, 2), offs=ends)
        return torch._grouped_mm(self._swiglu(h), self.down_proj.transpose(1, 2), offs=ends)

    def looped(self, xs: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
        """As ``grouped``, one expert's row range at a time (the ends are read
        on the host)."""
        out = torch.zeros_like(xs)
        start = 0
        for e, end in enumerate(ends.tolist()):
            if end > start:
                h = F.linear(xs[start:end], self.gate_up_proj[e])
                out[start:end] = F.linear(self._swiglu(h), self.down_proj[e])
            start = end
        return out

    def forward(self, xs: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
        return self.grouped(xs, ends) if xs.device.type == "cuda" else self.looped(xs, ends)


class MoE(nn.Module):
    """Router, routed experts and shared experts (``DeepseekV2MoE``)."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.top_k, self.norm_topk = cfg.num_experts_per_tok, cfg.norm_topk_prob
        self.scaling = cfg.routed_scaling_factor
        self.gate = nn.Linear(cfg.hidden_size, cfg.n_routed_experts, bias=False)
        self.experts = Experts(cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size)
        self.shared_experts = (MLP(cfg.hidden_size,
                                   cfg.moe_intermediate_size * cfg.n_shared_experts)
                               if cfg.n_shared_experts else None)

    def forward(self, x: torch.Tensor, load: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., H); ``load`` (E,) int64, when given, gains each expert's
        token count."""
        with span("moe"):
            shape = x.shape
            x = x.reshape(-1, shape[-1])
            w, _, ends, pos, xs = moe_dispatch(x, self.gate.weight, self.top_k, self.norm_topk,
                                               self.scaling, load)
            ys = self.experts(xs, ends)
            shared = None if self.shared_experts is None else self.shared_experts(x)
            return moe_combine(ys, w, pos, shared).view(shape)


class MLA(nn.Module):
    """Multi-head latent attention without a q LoRA (``DeepseekV2Attention``)."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.heads, self.rank = cfg.num_attention_heads, cfg.kv_lora_rank
        self.nope, self.rope, self.vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        h = cfg.hidden_size
        self.q_proj = nn.Linear(h, self.heads * cfg.q_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(h, self.rank + self.rope, bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(self.rank, self.heads * (self.nope + self.vdim), bias=False)
        self.o_proj = nn.Linear(self.heads * self.vdim, h, bias=False)
        self.scale, self.mscale = softmax_scale(cfg), rope_mscale(cfg)

    def _latent(self, x: torch.Tensor, freqs: torch.Tensor):
        """x (..., H) -> q_nope (..., heads, nope), the rotated q_pe (...,
        heads, rope) and the cache row (..., rank + rope)."""
        q = self.q_proj(x).unflatten(-1, (self.heads, self.nope + self.rope))
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], dim=-1)
        q_pe = apply_rope(q_pe, freqs.unsqueeze(-2), self.mscale)
        row = torch.cat([self.kv_a_layernorm(c), apply_rope(k_pe, freqs, self.mscale)], dim=-1)
        return q_nope, q_pe, row

    def forward(self, x: torch.Tensor, freqs: torch.Tensor,
                cache: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The full form over a causal sequence x (B, S, H) at positions
        0..S-1 (``freqs`` (S, rope / 2)); writes the rows to ``cache``
        (B, L >= S, rank + rope) when given."""
        b, s, _ = x.shape
        q_nope, q_pe, row = self._latent(x, freqs)
        if cache is not None:
            cache[:, :s] = row
        c, k_pe = row.split([self.rank, self.rope], dim=-1)
        kv = self.kv_b_proj(c).unflatten(-1, (self.heads, self.nope + self.vdim))
        k_nope, v = kv.split([self.nope, self.vdim], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, self.heads, self.rope)],
                      dim=-1).transpose(1, 2)
        v = F.pad(v, (0, self.nope + self.rope - self.vdim)).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=self.scale)
        o = o[..., : self.vdim].transpose(1, 2).reshape(b, s, self.heads * self.vdim)
        return self.o_proj(o)

    def step(self, x: torch.Tensor, freqs: torch.Tensor, cache: torch.Tensor, t,
             index: Optional[torch.Tensor]) -> torch.Tensor:
        """The absorbed form for one token a row, x (B, 1, H), at position
        ``t`` (an int, or a 0-d int32 tensor on the device with ``index`` its
        (1,) int64 copy): the row is written IN PLACE to ``cache`` (B, L,
        rank + rope), then the queries attend over positions <= t."""
        b = x.shape[0]
        q_nope, q_pe, row = self._latent(x[:, 0], freqs)
        if index is not None:
            cache.index_copy_(1, index, row[:, None])
        else:
            cache[:, t] = row
        w = self.kv_b_proj.weight.view(self.heads, self.nope + self.vdim, self.rank)
        q_lat = torch.bmm(q_nope.transpose(0, 1), w[:, : self.nope])        # (heads, B, rank)
        q = torch.cat([q_lat.transpose(0, 1), q_pe], dim=-1).contiguous()  # (B, heads, 576)
        o_lat = latent_decode(q, cache, t, scale=self.scale, dv=self.rank)  # (B, heads, rank)
        o = torch.bmm(o_lat.transpose(0, 1), w[:, self.nope:].transpose(1, 2))
        return self.o_proj(o.transpose(0, 1).reshape(b, 1, self.heads * self.vdim))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MoE(cfg) if cfg.is_moe(i) else MLP(cfg.hidden_size, cfg.intermediate_size)


class DeepseekV2Decoder(nn.Module):
    """Embedding, ``num_hidden_layers`` MLA + SwiGLU / MoE layers, final
    norm, untied head. ``prefill_tokens`` bounds the tokens of one chunk of
    ``prefill`` (whole rows a chunk), which bounds its activations."""

    def __init__(self, cfg: DeepseekV2Config, prefill_tokens: int = 1 << 16):
        super().__init__()
        self.cfg, self.prefill_tokens = cfg, prefill_tokens
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        n_moe = sum(cfg.is_moe(i) for i in range(cfg.num_hidden_layers))
        self.register_buffer("inv_freq", yarn_inv_freq(cfg), persistent=False)
        self.register_buffer("expert_load", torch.zeros(n_moe, cfg.n_routed_experts,
                                                        dtype=torch.int64), persistent=False)

    @classmethod
    def empty(cls, cfg: DeepseekV2Config, device, dtype=torch.float32,
              prefill_tokens: int = 1 << 16) -> "DeepseekV2Decoder":
        """The decoder in ``dtype`` on ``device`` with its parameters
        allocated and not set (built on the meta device first, so no
        float32 copy of a bf16 model is ever made)."""
        with torch.device("meta"):
            m = cls(cfg, prefill_tokens)
        return m.to(dtype).to_empty(device=device)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded weights, drawn in place in the order of
        ``named_parameters``: every matrix and the embedding N(0, std^2),
        std the configuration's ``initializer_range``, the RMSNorm scales 1
        (DeepSeek's ``_init_weights``), and each router (``mlp.gate.weight``)
        N(0, 1 / hidden): unit-variance gate logits at a unit-RMS input, so
        that the top-k stand apart by margins of the order a trained
        router's have (at ``std`` the logits would lie within bf16 rounding
        of each other). The ``dsv2_lite`` benchmark configuration states
        these (its ``assumed``)."""
        std = self.cfg.initializer_range
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("norm.weight"):
                    p.fill_(1.0)
                elif name.endswith("mlp.gate.weight"):
                    p.normal_(0.0, self.cfg.hidden_size ** -0.5, generator=generator)
                else:
                    p.normal_(0.0, std, generator=generator)

    def _apply(self, fn, recurse=True):
        """After a move or a cast (``to``, ``to_empty``): the inverse
        frequencies stay fp32, as DeepSeek keeps them whatever the model's
        dtype, and the expert counts start from 0."""
        super()._apply(fn, recurse)
        dev = self.inv_freq.device
        self.inv_freq = yarn_inv_freq(self.cfg).to(dev)
        self.expert_load = torch.zeros(self.expert_load.shape, dtype=torch.int64, device=dev)
        return self

    @property
    def head(self) -> nn.Linear:
        return self.lm_head

    def _freqs(self, positions) -> torch.Tensor:
        """(..., rope / 2) fp32 angles at ``positions`` (a tensor, an int, or
        a 0-d tensor on the device)."""
        if isinstance(positions, torch.Tensor):
            return positions.float()[..., None] * self.inv_freq
        return self.inv_freq * float(positions)

    def _layers(self, h: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
        freqs = self._freqs(torch.arange(h.shape[1], device=h.device))
        for i, layer in enumerate(self.layers):
            h = h + layer.self_attn(layer.input_layernorm(h), freqs,
                                    None if cache is None else cache[f"c_{i}"])
            h = h + layer.mlp(layer.post_attention_layernorm(h))
        return self.norm(h)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) ids -> (B, S, vocab) logits of the full causal pass."""
        return self.lm_head(self._layers(self.embed_tokens(tokens.long()), None))

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
        """One (batch, max_len, kv_lora_rank + rope) latent row a layer."""
        width = self.cfg.kv_lora_rank + self.cfg.qk_rope_head_dim
        return {f"c_{i}": torch.zeros(batch, max_len, width, dtype=dtype, device=device)
                for i in range(self.cfg.num_hidden_layers)}

    def prefill(self, prompt: torch.Tensor, cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Writes the cache rows of positions [0, P) of ``prompt`` (B, P) and
        returns the (B, vocab) logits of its last position: the full form, in
        chunks of whole rows of at most ``prefill_tokens`` tokens."""
        b, p = prompt.shape
        rows = max(1, self.prefill_tokens // max(1, p))
        out = []
        with span("prefill", tokens=b * p):
            for r0 in range(0, b, rows):
                sl = slice(r0, min(b, r0 + rows))
                h = self._layers(self.embed_tokens(prompt[sl].long()),
                                 {k: c[sl] for k, c in cache.items()})
                out.append(self.lm_head(h[:, -1]))
        return torch.cat(out)

    def decode_step(self, token: torch.Tensor, cache: Dict[str, torch.Tensor], t) -> torch.Tensor:
        """token (B, 1) at position ``t`` (an int, or a 0-d int32 tensor on the
        device) -> (B, vocab) logits; the absorbed form, the latent rows
        written IN PLACE; each expert layer's token counts go to
        ``expert_load``."""
        index = t.view(1).long() if device_step(t) else None
        freqs = self._freqs(t)
        h = self.embed_tokens(token.long())
        j = 0
        for i, layer in enumerate(self.layers):
            h = h + layer.self_attn.step(layer.input_layernorm(h), freqs, cache[f"c_{i}"], t,
                                         index)
            x = layer.post_attention_layernorm(h)
            if isinstance(layer.mlp, MoE):
                h = h + layer.mlp(x, self.expert_load[j])
                j += 1
            else:
                h = h + layer.mlp(x)
        return self.lm_head(self.norm(h))[:, 0]

