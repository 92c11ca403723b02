"""Plain reference of ``slm_vico``: SLM pretraining and SLMFT's best-of-N
generation (seq2seq_pretrain.py:72-514), with its two listener-width VQ-VAE
tokenizers (stage1_BIWI.py), written from the reference's equations on the
building blocks of ``common``. It reads the weights the benchmark made, by
their state_dict keys, and works out everything else itself."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import Prec, Weights, nearest_codes, vq_decode, vq_encode, xdecoder, xencoder

IGNORE = -100
FROZEN = ("speaker_vq.quantize", "speaker_vq.encoder", "listener_vq.quantize",
          "listener_vq.encoder")


def _ln(W: Weights, key: str, x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x, x.shape[-1:], W[key + ".weight"],
                                          W[key + ".bias"], 1e-6)


def _codes(P: Prec, W: Weights, vq: dict, which: str, x, lengths) -> torch.Tensor:
    z = vq_encode(P, W, which, vq, x, lengths)
    return nearest_codes(z, W[which + ".quantize.embedding.weight"])[..., 0]


def _motion(P: Prec, W: Weights, vq: dict, which: str, codes, rows=None) -> torch.Tensor:
    zq = W[which + ".quantize.embedding.weight"][codes]
    return vq_decode(P, W, which + ".decoder", vq, zq, "vertice_map_reverse.weight", rows)


# --- SLMFT generation ------------------------------------------------------

def context(P: Prec, W: Weights, slm: dict, speaker, audio, mask) -> torch.Tensor:
    """The decoder's context (B, L, dim + dim_audio): the speaker stream
    through encoder_s and encoder_joint under a causal mask, norm_s, plus
    patch_embed_dec_s, beside the audio features."""
    x = speaker + W["patch_embed_s"]
    x = xencoder(P, W, "encoder_s", slm, x, mask, causal=True)
    x = xencoder(P, W, "encoder_joint", slm, x, mask, causal=True)
    x = _ln(W, "norm_s", x)
    return torch.cat([x + W["patch_embed_dec_s"], audio], dim=-1)


def prompt_candidates(W: Weights, vq: dict, listener, mask, k: int = 2) -> torch.Tensor:
    """The k nearest listener codes of each clip's first frame, (B, k): the
    prompt is the first code of the listener VQ's tokenization, computed in
    fp32 with the clip's length."""
    z = vq_encode(Prec("fp32"), W, "listener_vq", vq, listener, mask.sum(dim=1))
    return nearest_codes(z[:, :1], W["listener_vq.quantize.embedding.weight"], k)[:, 0]


def logits(P: Prec, W: Weights, slm: dict, prompt, tokens, ctx, mask, ctx_rows) -> torch.Tensor:
    """Teacher-forced logits (R, n, vocab) of rows ``prompt`` (R,) followed
    by their served ``tokens`` (R, n) less the last: position t predicts
    token t."""
    seq = torch.cat([prompt[:, None], tokens[:, :-1]], dim=1)
    return xdecoder(P, W, "decoder_joint.net", slm, seq, ctx, mask, ctx_rows)


def motion(P: Prec, W: Weights, vq: dict, tokens, rows) -> torch.Tensor:
    """Served codes (R, n) -> listener motion (R, n, 56), row r decoded as
    batch position ``rows[r]`` of the generate call."""
    return _motion(P, W, vq, "listener_vq", tokens, rows)


# --- SLM pretraining -------------------------------------------------------

def _masking(noise, valid, ratio: float) -> torch.Tensor:
    noise = torch.where(valid, noise, float("inf"))
    ranks = torch.argsort(torch.argsort(noise, dim=1, stable=True), dim=1, stable=True)
    k = (valid.sum(dim=1) * ratio).to(torch.int32)
    return ranks < k[:, None]


def _ce(lg, tgt) -> torch.Tensor:
    lp = torch.log_softmax(lg.float(), dim=-1)
    nll = -torch.gather(lp, -1, tgt.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
    keep = (tgt != IGNORE).float()
    return (nll * keep).sum() / keep.sum().clamp_min(1.0)


def _cont(pred, target, m) -> torch.Tensor:
    target, m = target[:, 1:], m[:, 1:].float()
    n = min(pred.shape[1], target.shape[1])
    diff = pred[:, :n] - target[:, :n] + 1e-6
    d_pose = diff[..., :6].square().sum(-1).sqrt()
    d_exp = diff[..., 6:].square().sum(-1).sqrt()
    m = m[:, :n]
    den = m.sum().clamp_min(1.0)
    return (d_exp * m).sum() / den + (d_pose * m).sum() / den


def slm_loss(P: Prec, W: Weights, slm: dict, vq: dict, batch, noise) -> Tuple[torch.Tensor, Dict]:
    """The SLM's total loss on (speaker, listener, audio, mask) with the
    (speaker, listener) masking noise: masked-frame token CE both ways,
    the continuous loss of the VQ-decoded argmax codes, InfoNCE."""
    speaker, listener, audio, valid = batch
    lengths = valid.sum(dim=1)
    with torch.no_grad():
        z_s = _codes(P, W, vq, "speaker_vq", speaker, lengths)
        z_l = _codes(P, W, vq, "listener_vq", listener, lengths)
    pos_s = torch.arange(z_s.shape[1], device=z_s.device)[None, :]
    pos_l = torch.arange(z_l.shape[1], device=z_l.device)[None, :]
    z_s = torch.where(pos_s < (lengths * vq["face_quan_num"])[:, None], z_s, 0)
    z_l = torch.where(pos_l < lengths[:, None], z_l, IGNORE)
    m_s = _masking(noise[0], valid, slm["mask_ratio"])
    m_l = _masking(noise[1], valid, slm["mask_ratio"])
    v_s = (speaker + W["patch_embed_s"]).masked_fill(m_s[:, :, None], 0.0)
    v_l = (listener + W["patch_embed_l"]).masked_fill(m_l[:, :, None], 0.0)
    x_s = xencoder(P, W, "encoder_s", slm, v_s, valid)
    x_l = xencoder(P, W, "encoder_l", slm, v_l, valid)
    x_joint = xencoder(P, W, "encoder_joint", slm, torch.cat([x_s, x_l], 1),
                       torch.cat([valid, valid], 1))
    b, l = x_s.shape[0], x_s.shape[1]
    y = xencoder(P, W, "encoder_joint", slm, torch.cat([x_l, x_s], 0), torch.cat([valid, valid], 0))
    x_l, x_s = _ln(W, "norm_l", y[:b]), _ln(W, "norm_s", y[b:])
    x_joint = _ln(W, "norm", x_joint)
    # InfoNCE of the masked means
    m = valid.float()[:, :, None]
    s = (x_s * m).sum(1) / m.sum(1).clamp_min(1.0)
    li = (x_l * m).sum(1) / m.sum(1).clamp_min(1.0)
    s = s / s.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    li = li / li.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = (s @ li.T) / slm["contrastive_temp"]
    nce = -torch.diagonal(torch.log_softmax(sim, dim=0)).mean()
    # cross prediction of the masked codes, both directions in one batch
    z_s = torch.where(m_s, z_s, IGNORE)
    z_l = torch.where(m_l, z_l, IGNORE)
    ctx_s = torch.cat([x_joint[:, :l] + W["patch_embed_dec_s"], audio], -1)
    ctx_l = torch.cat([x_joint[:, l:] + W["patch_embed_dec_l"], audio], -1)
    inp = torch.cat([z_s[:, :-1], z_l[:, :-1]], 0)
    inp = torch.where(inp == IGNORE, 0, inp)
    px = xdecoder(P, W, "decoder_joint.net", slm, inp, torch.cat([ctx_l, ctx_s], 0),
                  torch.cat([valid, valid], 0))
    ce_s, ce_l = _ce(px[:b], z_s[:, 1:]), _ce(px[b:], z_l[:, 1:])
    pred_s = _motion(P, W, vq, "speaker_vq", px[:b].argmax(-1))
    pred_l = _motion(P, W, vq, "listener_vq", px[b:].argmax(-1))
    cont_s, cont_l = _cont(pred_s, speaker, m_s), _cont(pred_l, listener, m_l)
    total = ce_s + ce_l + cont_s + cont_l + nce
    return total, {"l_ce_s": ce_s, "l_ce_l": ce_l, "l_cont_s": cont_s, "l_cont_l": cont_l,
                   "nce": nce}


def trainable(W: Weights):
    return [k for k in W if not any(k == f or k.startswith(f + ".") for f in FROZEN)]
