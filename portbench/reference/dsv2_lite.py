"""Plain reference of a DeepSeek-V2 decoder's full forward pass, in fp32.

Written from DeepSeek-V2 (arXiv:2405.04434) and ``modeling_deepseek.py`` of
the published checkpoints, in plain PyTorch: no kernel, no cache, no
batching tricks, TF32 off. It imports nothing but torch and reads the
weights by the program's state_dict keys (``models/deepseek_v2.py`` of the
port, which it does not import) from a flat dict ``W``, upcasting each
weight to fp32 where it is used, so on the card one layer's weights at a
time are held in fp32 beside the program's bf16 ones. ``P``, when given,
rounds the operands of every matrix product but the router's (a lower
precision put in the program's place: the benchmark's control); its
``r(x)`` returns x rounded, in fp32.

Departures from ``modeling_deepseek.py``, none of which changes the
mathematics:
* the routed experts are a Python loop over the experts, each taking the
  (token, slot) pairs routed to it (``moe_infer`` sorts the pairs instead),
  and their weights are stacked: ``mlp.experts.gate_up_proj`` (E, 2I, H),
  each expert's gate rows then its up rows, and ``mlp.experts.down_proj``
  (E, H, I) in place of per-expert ``nn.Linear``s;
* the cos / sin tables are made at the sequence's length, not cached at
  ``max_position_embeddings`` (the same fp32 products);
* the head is applied from position ``logits_from`` on; there is no
  attention mask but the causal one, no dropout and no auxiliary loss
  (``seq_aux`` serves training only);
* it also returns, for every expert layer and token, the router's margin
  between its ``k``-th and ``k + 1``-th logit (fp32), from which a check
  counts the near ties of the top-k.

The benchmark keeps an identical copy as ``portbench/reference/dsv2_lite.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

Weights = Dict[str, torch.Tensor]


class _FP32:
    @staticmethod
    def r(x: torch.Tensor) -> torch.Tensor:
        return x.float()


FP32 = _FP32()


def fp32_matmuls() -> None:
    """TF32 off for every product the reference makes on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(P, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(P.r(x), P.r(w).t())


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return w.float() * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


# --- YaRN rope (DeepseekV2YarnRotaryEmbedding) ---------------------------

def yarn_find_correction_dim(num_rotations, dim, base=10000, max_position_embeddings=2048):
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base=10000,
                               max_position_embeddings=2048):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_position_embeddings))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_position_embeddings))
    return max(low, 0), min(high, dim - 1)


def yarn_get_mscale(scale=1, mscale=1):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_linear_ramp_mask(lo, hi, dim):
    if lo == hi:
        hi += 0.001
    return torch.clamp((torch.arange(dim, dtype=torch.float32) - lo) / (hi - lo), 0, 1)


def rope_tables(cfg: dict, seq_len: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(seq_len, rope_dim) cos and sin, as the rotary embedding caches them."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    rs = cfg.get("rope_scaling")
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    if rs:
        factor = rs["factor"]
        freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
        low, high = yarn_find_correction_range(rs["beta_fast"], rs["beta_slow"], dim, base,
                                               rs["original_max_position_embeddings"])
        inv_freq_mask = 1.0 - yarn_linear_ramp_mask(low, high, dim // 2)
        inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
        m = yarn_get_mscale(factor, rs["mscale"]) / yarn_get_mscale(factor, rs["mscale_all_dim"])
    else:
        inv_freq, m = freq_extra, 1.0
    t = torch.arange(seq_len, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q (B, H, S, d), k (B, 1, S, d), cos / sin (S, d)."""
    cos, sin = cos[None, None], sin[None, None]
    b, h, s, d = q.shape
    q = q.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    b, h, s, d = k.shape
    k = k.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


# --- layers ------------------------------------------------------------

def attention(P, W: Weights, pre: str, cfg: dict, x: torch.Tensor, cos, sin) -> torch.Tensor:
    """MLA in its full form (``DeepseekV2Attention.forward``), causal."""
    b, s, _ = x.shape
    nh, nope, rope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vdim, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = linear(P, x, W[pre + "q_proj.weight"]).view(b, s, nh, nope + rope).transpose(1, 2)
    q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
    ckv = linear(P, x, W[pre + "kv_a_proj_with_mqa.weight"])
    c, k_pe = torch.split(ckv, [rank, rope], dim=-1)
    k_pe = k_pe.view(b, s, 1, rope).transpose(1, 2)
    c = rms_norm(c, W[pre + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = linear(P, c, W[pre + "kv_b_proj.weight"]).view(b, s, nh, nope + vdim).transpose(1, 2)
    k_nope, v = torch.split(kv, [nope, vdim], dim=-1)
    q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, cos, sin)
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(b, nh, s, rope)], dim=-1)
    scores = torch.matmul(P.r(query), P.r(key).transpose(2, 3)) * softmax_scale(cfg)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.matmul(P.r(probs), P.r(v)).transpose(1, 2).reshape(b, s, nh * vdim)
    return linear(P, out, W[pre + "o_proj.weight"])


def swiglu(P, x, w_gate, w_up, w_down) -> torch.Tensor:
    g = linear(P, x, w_gate)
    return linear(P, torch.nn.functional.silu(g) * linear(P, x, w_up), w_down)


def mlp(P, W: Weights, pre: str, x: torch.Tensor) -> torch.Tensor:
    return swiglu(P, x, W[pre + "gate_proj.weight"], W[pre + "up_proj.weight"],
                  W[pre + "down_proj.weight"])


def moe(P, W: Weights, pre: str, cfg: dict, x: torch.Tensor):
    """``DeepseekV2MoE`` at inference: (y, margins (B, S)). The router in
    fp32, softmax scores, greedy top-k; the routed experts a loop."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).float()
    k, inter = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    logits = torch.matmul(xf, W[pre + "gate.weight"].float().t())
    scores = logits.softmax(dim=-1, dtype=torch.float32)
    topk_weight, topk_idx = torch.topk(scores, k=k, dim=-1, sorted=False)
    if k > 1 and cfg["norm_topk_prob"]:
        topk_weight = topk_weight / (topk_weight.sum(dim=-1, keepdim=True) + 1e-20)
    topk_weight = topk_weight * cfg["routed_scaling_factor"]
    ranked = logits.sort(dim=-1, descending=True).values
    margins = (ranked[:, k - 1] - ranked[:, k]).view(shape[:-1])
    y = torch.zeros_like(xf)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (topk_idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = W[pre + "experts.gate_up_proj"][e].float()
        out = swiglu(P, xf[tok], gu[:inter], gu[inter:], W[pre + "experts.down_proj"][e])
        y.index_add_(0, tok, out * topk_weight[tok, slot, None])
    if cfg["n_shared_experts"]:
        y = y + mlp(P, W, pre + "shared_experts.", xf)
    return y.view(shape), margins


def forward(W: Weights, cfg: dict, tokens: torch.Tensor, P=FP32,
            logits_from: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """tokens (B, S) -> fp32 logits (B, S - logits_from, vocab) of positions
    logits_from..S-1, and the router margins (expert layers, B, S) (None
    without expert layers)."""
    fp32_matmuls()
    b, s = tokens.shape
    eps = cfg["rms_norm_eps"]
    cos, sin = rope_tables(cfg, s, tokens.device)
    h = W["embed_tokens.weight"][tokens.long()].float()
    margins = []
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        x = rms_norm(h, W[pre + "input_layernorm.weight"], eps)
        h = h + attention(P, W, pre + "self_attn.", cfg, x, cos, sin)
        x = rms_norm(h, W[pre + "post_attention_layernorm.weight"], eps)
        moe_layer = (i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0)
        if moe_layer:
            y, m = moe(P, W, pre + "mlp.", cfg, x)
            margins.append(m)
        else:
            y = mlp(P, W, pre + "mlp.", x)
        h = h + y
    h = rms_norm(h[:, logits_from:], W["norm.weight"], eps)
    return linear(P, h, W["lm_head.weight"]), torch.stack(margins) if margins else None
