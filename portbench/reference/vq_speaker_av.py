"""Plain reference of ``vq_speaker_av``: the audio-visual speaker VQ-VAE's
training loss (stage1_BIWI.py:140-251, metrics/loss.py calc_vq_loss_AV),
on the building blocks of ``common``."""

from __future__ import annotations

import torch

from .common import Prec, Weights, near_ties, quantize, vq_decode, vq_encode

MOTION = 56
# Two codes whose squared distances to a latent lie within TIE of each other
# (relative) are a tie at fp32: the program's and the reference's latents
# differ by ~1e-6 relative (GEMM order, 3xTF32 attention), and the check
# takes either code there (``tie_alternatives``).
TIE = 1e-4
MOST_TIES = 16


def loss(P: Prec, W: Weights, vq: dict, x: torch.Tensor, switch=()):
    """L1 of the motion and of the audio reconstruction plus the
    quantization loss, on clips (B, L, 824) encoded without lengths:
    (total, {"rec_loss", "quant_loss"}). The latents at flat indices
    ``switch`` take their second-nearest code."""
    z = vq_encode(P, W, "", vq, x)
    zq, qloss, _ = quantize(z, W["quantize.embedding.weight"], switch=switch)
    pred = torch.cat([vq_decode(P, W, "decoder_v", vq, zq, "vertice_map_reverse.weight"),
                      vq_decode(P, W, "decoder_a", vq, zq, "vertice_map_reverse.weight")], -1)
    rec = ((pred[..., :MOTION] - x[..., :MOTION]).abs().mean()
           + (pred[..., MOTION:] - x[..., MOTION:]).abs().mean())
    return rec + qloss, {"rec_loss": rec, "quant_loss": qloss}


def trainable(W: Weights):
    return list(W)


def tie_alternatives(P: Prec, W: Weights, vq: dict, x: torch.Tensor) -> list:
    """The latents of ``x`` at ``W`` whose nearest code is a tie (``TIE``):
    one alternative quantization each, that latent on its second code."""
    with torch.no_grad():
        z = vq_encode(P, W, "", vq, x)
    return [[i] for i in near_ties(z, W["quantize.embedding.weight"], TIE, MOST_TIES)]
