"""Plain building blocks shared by the references: the precision of the
matrix products, the VQ-VAE tokenizers (stage1_BIWI), the x-transformers
layers of the SLM family, AdamW and the global-norm clip.

Every weight is looked up by its state_dict key in a flat dict ``W`` of
fp32 tensors. Every matrix product (linear, convolution, attention) goes
through ``Prec``: ``fp32`` computes in float32 with TF32 off; the lower
precisions round each operand before an fp32 product, ``tf32`` to TF32's
10-bit mantissa, ``bf16`` to bfloat16, ``fp8`` to float8 e4m3 with one scale
a tensor (its largest magnitude to 448). That is how the controls are made:
the reference in the nearest precision below the one a configuration
states."""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]


class Prec:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded to this precision, returned in fp32; gradients pass
        through the rounding unchanged."""
        x = x.float()
        if self.name == "fp32":
            return x
        with torch.no_grad():
            if self.name == "bf16":
                q = x.to(torch.bfloat16).float()
            elif self.name == "tf32":
                q = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
            else:
                s = 448.0 / x.abs().amax().clamp_min(1e-30)
                q = (x * s).to(torch.float8_e4m3fn).float() / s
        return x + (q - x).detach() if x.requires_grad else q

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.r(a), self.r(b))

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = torch.matmul(self.r(x), self.r(w).t())
        return y if b is None else y + b


def fp32_matmuls() -> None:
    """TF32 off for every product the reference makes on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sinusoid(n: int, d: int, device) -> torch.Tensor:
    """The sin/cos table of the VQ-VAEs' positional encoding, (n, d)."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-math.log(10000.0) / d))
    pe = np.zeros((n, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.as_tensor(pe, dtype=torch.float32, device=device)


def attention(P: Prec, q, k, v, scale: float, keep=None) -> torch.Tensor:
    """softmax(q k^T scale) v over (B, H, Lq, D); ``keep`` broadcasts to the
    scores, True = attend; a query that attends nothing gives 0."""
    s = P.mm(q, k.transpose(-1, -2)) * scale
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
        p = torch.softmax(s, dim=-1)
        p = torch.where(keep.any(dim=-1, keepdim=True), p, torch.zeros((), device=s.device))
    else:
        p = torch.softmax(s, dim=-1)
    return P.mm(p, v)


def heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.reshape(b, n, h, d // h).transpose(1, 2)


def unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


# --- the VQ-VAE tokenizers (stage1_BIWI.py; base_models.py) ---------------

def _conv_in(P: Prec, W: Weights, pre: str, x: torch.Tensor, neg: float,
             lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Conv1d(k=5, replicate padding) -> LeakyReLU -> InstanceNorm (no
    affine, eps 1e-5) over time, on (B, L, C). With ``lengths`` each clip is
    convolved and normalised over its own frames alone."""
    if lengths is not None:
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        idx = torch.minimum(pos, lengths[:, None] - 1)
        x = torch.gather(x, 1, idx[:, :, None].expand_as(x))
    h = F.pad(P.r(x).transpose(1, 2), (2, 2), mode="replicate")
    h = F.conv1d(h, P.r(W[pre + ".weight"]), W[pre + ".bias"]).transpose(1, 2)
    h = F.leaky_relu(h, neg)
    if lengths is None:
        mean = h.mean(dim=1, keepdim=True)
        var = (h - mean).square().mean(dim=1, keepdim=True)
    else:
        pos = torch.arange(h.shape[1], device=h.device)[None, :]
        m = (pos < lengths[:, None]).float()[:, :, None]
        n = lengths.float().clamp_min(1.0)[:, None, None]
        mean = (h * m).sum(dim=1, keepdim=True) / n
        var = ((h - mean).square() * m).sum(dim=1, keepdim=True) / n
    return (h - mean) * torch.rsqrt(var + 1e-5)


def layered(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)``, its activations recomputed in the backward pass
    (``torch.utils.checkpoint``) when a gradient is wanted: the reference
    keeps one layer's activations at a time, so that it fits beside the
    program's peak."""
    if torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def vq_transformer(P: Prec, W: Weights, pre: str, x: torch.Tensor, layers: int, n_heads: int,
                   key_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm (attention, MLP) pairs, no final norm: LayerNorm eps 1e-5,
    fused unbiased qkv, biased output, scale hidden ** -0.5 (the full width),
    tanh GELU."""
    d = x.shape[-1]
    keep = None if key_keep is None else key_keep[:, None, None, :]

    def layer(x, a, m):
        h = F.layer_norm(x, (d,), W[a + ".norm.weight"], W[a + ".norm.bias"], 1e-5)
        q, k, v = (heads(t, n_heads) for t in P.linear(h, W[a + ".fn.to_qkv.weight"]).chunk(3, -1))
        o = unheads(attention(P, q, k, v, d ** -0.5, keep))
        x = x + P.linear(o, W[a + ".fn.to_out.weight"], W[a + ".fn.to_out.bias"])
        h = F.layer_norm(x, (d,), W[m + ".norm.weight"], W[m + ".norm.bias"], 1e-5)
        h = F.gelu(P.linear(h, W[m + ".fn.l1.weight"], W[m + ".fn.l1.bias"]), approximate="tanh")
        return x + P.linear(h, W[m + ".fn.l2.weight"], W[m + ".fn.l2.bias"])

    for j in range(layers):
        a, m = f"{pre}.net.{2 * j}.fn", f"{pre}.net.{2 * j + 1}.fn"
        x = layered(lambda t, a=a, m=m: layer(t, a, m), x)
    return x


def vq_encode(P: Prec, W: Weights, pre: str, cfg: dict, x: torch.Tensor,
              lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Motion (B, L, in_dim) -> pre-quantization latents (B, L * fq, zq).
    Without ``lengths`` row b of the batch gets the positional encoding of
    position b on every frame (the reference's quirk); with them every row
    gets position 0 (the reference encoding one clip at a time)."""
    hs = cfg["hidden_size"]
    e = f"{pre}.encoder" if pre else "encoder"
    h = F.leaky_relu(P.linear(x, W[e + ".vertice_mapping.0.weight"],
                              W[e + ".vertice_mapping.0.bias"]), cfg["neg"])
    h = _conv_in(P, W, e + ".squasher.0.0", h, cfg["neg"], lengths)
    h = P.linear(h, W[e + ".encoder_linear_embedding.net.weight"],
                 W[e + ".encoder_linear_embedding.net.bias"])
    pe = sinusoid(max(h.shape[0], 1), hs, h.device)
    h = h + (pe[:1][None] if lengths is not None else pe[: h.shape[0], None, :])
    keep = None
    if lengths is not None:
        keep = torch.arange(h.shape[1], device=h.device)[None, :] < lengths[:, None]
    h = vq_transformer(P, W, e + ".encoder_transformer", h, cfg["num_hidden_layers"],
                       cfg["num_attention_heads"], keep)
    h = P.linear(h, W[e + ".encoder_linear_embedding_post.net.weight"],
                 W[e + ".encoder_linear_embedding_post.net.bias"])
    return h.reshape(h.shape[0], -1, cfg["zquant_dim"])


def nearest_codes(z: torch.Tensor, codebook: torch.Tensor, k: int = 1) -> torch.Tensor:
    """The k nearest codes of each latent (..., e) in float64, nearest first
    (ties to the lowest index)."""
    zf = z.reshape(-1, z.shape[-1]).double()
    e = codebook.double()
    d = (e * e).sum(dim=1)[None, :] - 2.0 * zf @ e.t()
    idx = torch.topk(-d, k, dim=1, sorted=True).indices if k > 1 else d.argmin(dim=1, keepdim=True)
    return idx.reshape(*z.shape[:-1], k)


def quantize(z: torch.Tensor, codebook: torch.Tensor, beta: float = 0.25, switch=()):
    """(straight-through latents, commitment + codebook loss, codes). The
    latents at the flat indices ``switch`` take their second-nearest code."""
    top = nearest_codes(z.detach(), codebook, 2 if len(switch) else 1)
    idx = top[..., 0].clone()
    if len(switch):
        flat, second = idx.view(-1), top.reshape(-1, 2)[:, 1]
        flat[list(switch)] = second[list(switch)]
    zq = codebook[idx]
    loss = beta * (zq.detach() - z).square().mean() + (zq - z.detach()).square().mean()
    return z + (zq - z).detach(), loss, idx


def near_ties(z: torch.Tensor, codebook: torch.Tensor, rel: float, most: int) -> list:
    """Flat indices of the latents (at most ``most``, closest first) whose
    two nearest codes lie within ``rel`` of each other relative to the
    nearest squared distance: where rounding at the stated precision may
    pick either."""
    zf = z.detach().reshape(-1, z.shape[-1]).double()
    e = codebook.double()
    d = (e * e).sum(dim=1)[None, :] - 2.0 * zf @ e.t()
    two = torch.topk(-d, 2, dim=1).values.neg()
    margin = (two[:, 1] - two[:, 0]) / ((zf * zf).sum(dim=1) + two[:, 0]).clamp_min(1e-30)
    order = torch.argsort(margin)[:most]
    return [int(i) for i in order if float(margin[i]) < rel]


def vq_decode(P: Prec, W: Weights, pre: str, cfg: dict, zq: torch.Tensor, out_key: str,
              rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Latents (B, L * fq, zq) -> motion (B, L, out) through one decoder
    (BIWI variant: pre projection, expander, embedding, positional encoding
    of the batch row, transformer, unbiased output). Row b takes the
    positional encoding of batch position ``rows[b]`` (b itself when
    ``rows`` is None: the reference decodes a batch without lengths)."""
    fz = cfg["face_quan_num"] * cfg["zquant_dim"]
    h = zq.reshape(zq.shape[0], -1, fz)
    d = pre
    h = P.linear(h, W[d + ".decoder_linear_embedding_pre.net.weight"],
                 W[d + ".decoder_linear_embedding_pre.net.bias"])
    h = _conv_in(P, W, d + ".expander.0.0", h, cfg["neg"], None)
    h = P.linear(h, W[d + ".decoder_linear_embedding.net.weight"],
                 W[d + ".decoder_linear_embedding.net.bias"])
    if rows is None:
        rows = torch.arange(h.shape[0], device=h.device)
    pe = sinusoid(int(rows.max()) + 1, cfg["hidden_size"], h.device)
    h = h + pe[rows][:, None, :]
    h = vq_transformer(P, W, d + ".decoder_transformer", h, cfg["num_hidden_layers"],
                       cfg["num_attention_heads"])
    return P.linear(h, W[d + "." + out_key])


# --- x-transformers layers of the SLM family ------------------------------

def xnorm(W: Weights, key: str, x: torch.Tensor) -> torch.Tensor:
    """Scale-only LayerNorm, eps 1e-6."""
    return F.layer_norm(x, x.shape[-1:], W[key + ".gamma"], None, 1e-6)


def xattn(P: Prec, W: Weights, pre: str, x: torch.Tensor, n_heads: int, dh: int,
          context: Optional[torch.Tensor] = None, keep=None) -> torch.Tensor:
    """Separate unbiased q/k/v/out projections, scale dh ** -0.5."""
    src = x if context is None else context
    q = heads(P.linear(x, W[pre + ".to_q.weight"]), n_heads)
    k = heads(P.linear(src, W[pre + ".to_k.weight"]), n_heads)
    v = heads(P.linear(src, W[pre + ".to_v.weight"]), n_heads)
    return P.linear(unheads(attention(P, q, k, v, dh ** -0.5, keep)), W[pre + ".to_out.weight"])


def xff(P: Prec, W: Weights, pre: str, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(P.linear(x, W[pre + ".ff.0.0.weight"], W[pre + ".ff.0.0.bias"]))
    return P.linear(h, W[pre + ".ff.3.weight"], W[pre + ".ff.3.bias"])


def xencoder(P: Prec, W: Weights, pre: str, cfg: dict, x: torch.Tensor,
             key_keep: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """project_in -> + learned positions x dim ** -0.5 -> pre-norm (self
    attention, feedforward) x depth -> final norm."""
    d = cfg["dim"]
    h = P.linear(x, W[pre + ".project_in.weight"], W[pre + ".project_in.bias"])
    h = h + W[pre + ".pos_emb.emb.weight"][: h.shape[1]][None] * d ** -0.5
    n = h.shape[1]
    keep = key_keep[:, None, None, :]
    if causal:
        keep = keep & torch.ones(n, n, dtype=torch.bool, device=h.device).tril()[None, None]
    a = pre + ".attn_layers.layers"

    def layer(h, i):
        h = h + xattn(P, W, f"{a}.{2 * i}.1", xnorm(W, f"{a}.{2 * i}.0.0", h),
                      cfg["enc_heads"], cfg["attn_dim_head"], keep=keep)
        return h + xff(P, W, f"{a}.{2 * i + 1}.1", xnorm(W, f"{a}.{2 * i + 1}.0.0", h))

    for i in range(cfg["enc_depth"]):
        h = layered(lambda t, i=i: layer(t, i), h)
    return xnorm(W, pre + ".attn_layers.final_norm", h)


def xdecoder(P: Prec, W: Weights, pre: str, cfg: dict, tokens: torch.Tensor,
             context: torch.Tensor, context_keep: torch.Tensor,
             ctx_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token decoder, teacher-forced: embeddings [+ positions x dim ** -0.5]
    -> (causal self attention, cross attention, feedforward) x depth ->
    final norm -> logits (B, n, vocab). ``ctx_rows`` maps each token row to
    its context row (best-of-N rows share their clip's context)."""
    d = cfg["dim"] + cfg["dim_audio"]
    h = W[pre + ".token_emb.emb.weight"][tokens]
    if pre + ".pos_emb.emb.weight" in W:
        h = h + W[pre + ".pos_emb.emb.weight"][: tokens.shape[1]][None] * d ** -0.5
    if ctx_rows is not None:
        context, context_keep = context[ctx_rows], context_keep[ctx_rows]
    n = tokens.shape[1]
    causal = torch.ones(n, n, dtype=torch.bool, device=h.device).tril()[None, None]
    ckeep = context_keep[:, None, None, :]
    a = pre + ".attn_layers.layers"
    nh, dh = cfg["dec_heads"], cfg["attn_dim_head"]

    def layer(h, i):
        h = h + xattn(P, W, f"{a}.{3 * i}.1", xnorm(W, f"{a}.{3 * i}.0.0", h), nh, dh,
                      keep=causal)
        h = h + xattn(P, W, f"{a}.{3 * i + 1}.1", xnorm(W, f"{a}.{3 * i + 1}.0.0", h), nh, dh,
                      context=context, keep=ckeep)
        return h + xff(P, W, f"{a}.{3 * i + 2}.1", xnorm(W, f"{a}.{3 * i + 2}.0.0", h))

    for i in range(cfg["dec_depth"]):
        h = layered(lambda t, i=i: layer(t, i), h)
    h = xnorm(W, pre + ".attn_layers.final_norm", h)
    return P.linear(h, W[pre + ".to_logits.weight"])


# --- optimisation ----------------------------------------------------------

def clip_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> None:
    """Every gradient times min(1, max_norm / global norm), in place."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = min(1.0, max_norm / float(norm)) if float(norm) > 0 else 1.0
    for g in grads.values():
        g.mul_(scale)


class AdamW:
    """AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay) on a dict
    of fp32 tensors, updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, wd: float):
        self.p, self.lr, self.wd, self.t = params, lr, wd, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, g in grads.items():
            p, m, v = self.p[k], self.m[k], self.v[k]
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.mul_(1 - self.lr * self.wd)
            p.addcdiv_(m, v.sqrt() / math.sqrt(c2) + 1e-8, value=-self.lr / c1)


def first_step(loss_fn, W0: Weights, trainable, batch, clip: float = 0.0):
    """One forward and backward of ``loss_fn`` at ``W0``: (loss, parts, the
    gradients as the optimizer would get them)."""
    W = dict(W0)
    params = {k: W0[k].detach().clone().requires_grad_(True) for k in trainable}
    W.update(params)
    loss, part = loss_fn(W, batch)
    loss.backward()
    grads = {k: p.grad for k, p in params.items() if p.grad is not None}
    if clip > 0:
        clip_global_norm(grads, clip)
    return float(loss.detach()), {k: float(v.detach()) for k, v in part.items()}, grads


def train_steps(loss_fn, W0: Weights, trainable, batches, lr: float, wd: float,
                clip: float = 0.0):
    """Steps of ``loss_fn(W, batch) -> (loss, {part: value})`` from the
    weights ``W0`` (left as they are), one a batch: returns (each step's
    loss, each step's parts, the first step's gradients as the optimizer
    got them, the trainable weights after the last step)."""
    W = {k: v.detach().clone() for k, v in W0.items()}
    params = {k: W[k] for k in trainable}
    opt = AdamW(params, lr, wd)
    losses, parts, first = [], [], None
    for batch in batches:
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        loss, part = loss_fn(W, batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items() if p.grad is not None}
        for p in params.values():
            p.requires_grad_(False)
        if clip > 0:
            clip_global_norm(grads, clip)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
        parts.append({k: float(v.detach()) for k, v in part.items()})
    return losses, parts, first, {k: v.detach() for k, v in params.items()}
