"""VQ-VAE facial-motion tokenizers, BIWI variant (stage1_BIWI.py:10-411).

Counterpart of ``dyadic_interaction_modeling_tpu/models/vq_vae.py:58-222``.
Module keys follow ``stage1_BIWI`` so a reference state_dict loads with
``strict=True``. Tensors are (B, L, C) at every public function.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.convseq import ConvExpander, ConvSquasher
from ..ops.positional import PositionalEncoding
from ..ops.quantizer import VectorQuantizer
from ..ops.transformer import LinearEmbedding, Transformer


def _key_mask(lengths: Optional[torch.Tensor], l: int, device) -> Optional[torch.Tensor]:
    if lengths is None:
        return None
    return (torch.arange(l, device=device)[None, :] < lengths[:, None])[:, None, :]


class TransformerEncoder(nn.Module):
    """Motion -> pre-quant latents: vertice_mapping -> squasher -> linear
    embedding -> positional encoding -> transformer -> post linear.

    With ``lengths`` the batched encode equals encoding each sample's
    unpadded sequence alone (edge-filled conv, masked instance norm,
    key-masked attention, ``single`` positional mode)."""

    def __init__(self, cfg):
        super().__init__()
        hs = cfg.hidden_size
        self.vertice_mapping = nn.Sequential(nn.Linear(cfg.in_dim, hs),
                                             nn.LeakyReLU(cfg.neg))
        self.squasher = ConvSquasher(hs, hs, cfg.quant_factor, cfg.neg, cfg.INaffine)
        self.encoder_linear_embedding = LinearEmbedding(hs, hs)
        self.encoder_pos_embedding = PositionalEncoding(hs)
        self.encoder_transformer = Transformer(hs, cfg.num_hidden_layers,
                                               cfg.num_attention_heads,
                                               cfg.intermediate_size)
        self.encoder_linear_embedding_post = LinearEmbedding(
            hs, cfg.face_quan_num * cfg.zquant_dim)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.vertice_mapping(x)
        h = self.squasher(h, lengths)
        h = self.encoder_linear_embedding(h)
        h = self.encoder_pos_embedding(h, "batch" if lengths is None else "single")
        h = self.encoder_transformer(h, _key_mask(lengths, h.shape[1], h.device))
        return self.encoder_linear_embedding_post(h)


class TransformerDecoder(nn.Module):
    """Quantized latents -> motion: pre linear -> expander -> linear
    embedding -> positional encoding -> transformer -> unbiased output."""

    def __init__(self, cfg, out_dim: int):
        super().__init__()
        hs = cfg.hidden_size
        self.decoder_linear_embedding_pre = LinearEmbedding(
            cfg.face_quan_num * cfg.zquant_dim, hs)
        self.expander = ConvExpander(hs, hs, cfg.quant_factor, cfg.neg, cfg.INaffine)
        self.decoder_linear_embedding = LinearEmbedding(hs, hs)
        self.decoder_pos_embedding = PositionalEncoding(hs)
        self.decoder_transformer = Transformer(hs, cfg.num_hidden_layers,
                                               cfg.num_attention_heads,
                                               cfg.intermediate_size)
        self.vertice_map_reverse = nn.Linear(hs, out_dim, bias=False)

    def forward(self, h: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.decoder_linear_embedding_pre(h)
        h = self.expander(h, lengths)
        h = self.decoder_linear_embedding(h)
        h = self.decoder_pos_embedding(h, "batch" if lengths is None else "single")
        h = self.decoder_transformer(h, _key_mask(lengths, h.shape[1], h.device))
        return self.vertice_map_reverse(h)


class VQAutoEncoder(nn.Module):
    """Listener / speaker motion VQ-VAE, BIWI variant.

    ``with_decoder=False`` builds the encoder and codebook only: SLMFT's
    speaker tokenizer never decodes, and the JAX package's param tree holds
    no decoder for it, so neither does this module (strict loads stay
    possible)."""

    def __init__(self, cfg, with_decoder: bool = True):
        super().__init__()
        self.face_quan_num = cfg.face_quan_num
        self.zquant_dim = cfg.zquant_dim
        self.encoder = TransformerEncoder(cfg)
        if with_decoder:
            self.decoder = TransformerDecoder(cfg, cfg.in_dim)
        self.quantize = VectorQuantizer(cfg.n_embed, cfg.zquant_dim, beta=0.25)

    def encode_indices(self, x: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L, C) [+ lengths] -> (B, L*fq) int32 codes."""
        h = self.encoder(x, lengths)
        b, l, _ = h.shape
        h = h.reshape(b, l * self.face_quan_num, self.zquant_dim)
        return self.quantize(h).indices

    def decode_indices(self, indices: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L*fq) codes -> (B, L, in_dim) motion; ``lengths`` (token level)
        gives the per-sample-equivalent masked decode. Without it, row b of
        the batch gets positional encoding b (the reference quirk)."""
        z_q = self.quantize.get_codebook_entry(indices)
        b = indices.shape[0]
        h = z_q.reshape(b, -1, self.face_quan_num * self.zquant_dim)
        if lengths is not None:
            lengths = lengths // self.face_quan_num
        return self.decoder(h, lengths)
