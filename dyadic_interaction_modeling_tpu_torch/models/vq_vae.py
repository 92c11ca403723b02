"""VQ-VAE facial-motion tokenizers, BIWI variant (stage1_BIWI.py:10-411).

Counterpart of ``dyadic_interaction_modeling_tpu/models/vq_vae.py:58-330``:
the listener tokenizer's encode and decode, the training forward
(reconstruction, quantization loss and perplexity) and the code-space
utilities, and the audio-visual speaker tokenizer (``VQSpeakerAutoEncoder``).
Module keys follow ``stage1_BIWI`` so a reference state_dict loads with
``strict=True``.
Motion is (B, L, C) at every public function, quantized latents (B, C, L)
as the reference keeps them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.convseq import ConvExpander, ConvSquasher
from ..ops.positional import PositionalEncoding
from ..ops.quantizer import VectorQuantizer
from ..ops.transformer import LinearEmbedding, Transformer


class VQEncodeResult(NamedTuple):
    quant: torch.Tensor       # (B, zquant_dim, L*fq) straight-through latents
    emb_loss: torch.Tensor    # scalar commitment + codebook loss
    perplexity: torch.Tensor  # scalar codebook-usage perplexity
    indices: torch.Tensor     # (B, L*fq) int32 codes


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

    def encode(self, x: torch.Tensor,
               lengths: Optional[torch.Tensor] = None) -> VQEncodeResult:
        """(B, L, C) [+ lengths] -> quantized latents, loss, perplexity and
        codes."""
        h = self.encoder(x, lengths)
        b, l, _ = h.shape
        q = self.quantize(h.reshape(b, l * self.face_quan_num, self.zquant_dim))
        return VQEncodeResult(q.z_q, q.loss, q.perplexity, q.indices)

    def encode_indices(self, x: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L, C) [+ lengths] -> (B, L*fq) int32 codes."""
        return self.encode(x, lengths).indices

    def decode(self, quant: torch.Tensor,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, zquant_dim, L*fq) latents -> (B, L, in_dim) motion; ``lengths``
        (token level) gives the per-sample-equivalent masked decode. Without
        it, row b of the batch gets positional encoding b (the reference
        quirk)."""
        b = quant.shape[0]
        h = quant.transpose(1, 2).reshape(b, -1, self.face_quan_num * self.zquant_dim)
        if lengths is not None:
            lengths = lengths // self.face_quan_num
        return self.decoder(h, lengths)

    def decode_indices(self, indices: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L*fq) codes -> (B, L, in_dim) motion, through the codebook."""
        return self.decode(self.quantize.get_codebook_entry(indices).transpose(1, 2), lengths)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, VQEncodeResult]:
        """The training pass: (reconstruction, quantization loss, encode
        result)."""
        enc = self.encode(x)
        return self.decode(enc.quant), enc.emb_loss, enc

    def get_quant(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        enc = self.encode(x)
        return enc.quant, enc.indices

    def get_distances(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, C) motion -> (B, L*fq, n_embed) squared code distances."""
        h = self.encoder(x)
        b, l, _ = h.shape
        h = h.reshape(b, l * self.face_quan_num, self.zquant_dim)
        return self.quantize.get_distance(h.transpose(1, 2))

    def decode_to_img(self, indices: torch.Tensor, zshape: Tuple[int, int, int]
                      ) -> torch.Tensor:
        """Codes of any shape, looked up as (B, L, C) ``zshape``, decoded."""
        z_q = self.quantize.get_codebook_entry(indices.reshape(-1)).reshape(zshape)
        return self.decode(z_q.transpose(1, 2))

    def entry_to_feature(self, indices: torch.Tensor, zshape: Tuple[int, ...]
                         ) -> torch.Tensor:
        return self.quantize.get_codebook_entry(indices.reshape(-1)).reshape(zshape)


class VQSpeakerAutoEncoder(nn.Module):
    """The audio-visual speaker VQ-VAE (stage1_BIWI.py:140-251): one encoder
    over [motion (56) || audio (768)], ``face_quan_num`` codes a frame, and two
    decoders, ``decoder_v`` (motion) and ``decoder_a`` (audio), whose outputs
    are concatenated [v, a]. At ``vq_speaker_defaults()`` the attention has
    8 heads of 768 / 8 = 96."""

    def __init__(self, cfg, motion_dim: int = 56, audio_dim: int = 768):
        super().__init__()
        self.face_quan_num = cfg.face_quan_num
        self.zquant_dim = cfg.zquant_dim
        self.encoder = TransformerEncoder(cfg)
        self.decoder_v = TransformerDecoder(cfg, motion_dim)
        self.decoder_a = TransformerDecoder(cfg, audio_dim)
        self.quantize = VectorQuantizer(cfg.n_embed, cfg.zquant_dim, beta=0.25)

    def encode(self, x: torch.Tensor) -> VQEncodeResult:
        """(B, L, 824) -> quantized latents (B, zquant_dim, L*fq), loss,
        perplexity and (B, L*fq) codes."""
        h = self.encoder(x)
        b, l, _ = h.shape
        q = self.quantize(h.reshape(b, l * self.face_quan_num, self.zquant_dim))
        return VQEncodeResult(q.z_q, q.loss, q.perplexity, q.indices)

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """(B, zquant_dim, L*fq) latents -> (B, L, 56 + 768) [motion, audio]."""
        b = quant.shape[0]
        h = quant.transpose(1, 2).reshape(b, -1, self.face_quan_num * self.zquant_dim)
        return torch.cat([self.decoder_v(h), self.decoder_a(h)], dim=-1)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, VQEncodeResult]:
        """The training pass: (reconstruction, quantization loss, encode
        result)."""
        enc = self.encode(x)
        return self.decode(enc.quant), enc.emb_loss, enc

    def get_quant(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        enc = self.encode(x)
        return enc.quant, enc.indices

    def decode_to_img(self, indices: torch.Tensor, zshape: Tuple[int, int, int]
                      ) -> torch.Tensor:
        """Codes of any shape, looked up as (B, L, C) ``zshape``, decoded."""
        z_q = self.quantize.get_codebook_entry(indices.reshape(-1)).reshape(zshape)
        return self.decode(z_q.transpose(1, 2))

