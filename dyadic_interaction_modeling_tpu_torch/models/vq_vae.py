"""VQ-VAE facial-motion tokenizers (stage1_BIWI.py:10-411, stage1_vocaset.py).

Counterpart of ``dyadic_interaction_modeling_tpu/models/vq_vae.py:58-330``:
the listener tokenizer's encode and decode (BIWI and vocaset variants), the
training forward (reconstruction, quantization loss and perplexity), the
code-space utilities with ``decode_logit`` and ``get_logit``, and the
audio-visual speaker tokenizer (``VQSpeakerAutoEncoder``).
Module keys follow ``stage1_BIWI`` so a reference state_dict loads with
``strict=True``.
Motion is (B, L, C) at every public function, quantized latents (B, C, L)
as the reference keeps them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from .xtrans import gumbel_noise

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
    embedding -> positional encoding -> transformer [-> post linear, the
    BIWI variant's hidden -> fq * zq projection, ``project_to_quant``].

    With ``lengths`` the batched encode equals encoding each sample's
    unpadded sequence alone (edge-filled conv, masked instance norm,
    key-masked attention, ``single`` positional mode)."""

    def __init__(self, cfg, project_to_quant: bool = True):
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
        if project_to_quant:
            self.encoder_linear_embedding_post = LinearEmbedding(
                hs, cfg.face_quan_num * cfg.zquant_dim)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.vertice_mapping(x)
        h = self.squasher(h, lengths)
        h = self.encoder_linear_embedding(h)
        h = self.encoder_pos_embedding(h, "batch" if lengths is None else "single")
        h = self.encoder_transformer(h, _key_mask(lengths, h.shape[1], h.device))
        if hasattr(self, "encoder_linear_embedding_post"):
            h = self.encoder_linear_embedding_post(h)
        return h


class TransformerDecoder(nn.Module):
    """Quantized latents -> motion: [pre linear, the BIWI variant's fq * zq
    -> hidden, ``project_from_quant``] -> expander -> linear embedding ->
    positional encoding -> transformer -> output projection, unbiased in the
    BIWI variant and biased in the vocaset one (``out_bias``)."""

    def __init__(self, cfg, out_dim: int, project_from_quant: bool = True,
                 out_bias: bool = False):
        super().__init__()
        hs = cfg.hidden_size
        fz = cfg.face_quan_num * cfg.zquant_dim
        if project_from_quant:
            self.decoder_linear_embedding_pre = LinearEmbedding(fz, hs)
        self.expander = ConvExpander(hs if project_from_quant else fz, hs,
                                     cfg.quant_factor, cfg.neg, cfg.INaffine)
        self.decoder_linear_embedding = LinearEmbedding(hs, hs)
        self.decoder_pos_embedding = PositionalEncoding(hs)
        self.decoder_transformer = Transformer(hs, cfg.num_hidden_layers,
                                               cfg.num_attention_heads,
                                               cfg.intermediate_size)
        self.vertice_map_reverse = nn.Linear(hs, out_dim, bias=out_bias)

    def forward(self, h: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                return_feats: bool = False) -> torch.Tensor:
        """(B, L, fq * zq) -> (B, L', out_dim) motion, or with
        ``return_feats`` the transformer's (B, L', hidden) features."""
        if hasattr(self, "decoder_linear_embedding_pre"):
            h = self.decoder_linear_embedding_pre(h)
        h = self.expander(h, lengths)
        h = self.decoder_linear_embedding(h)
        h = self.decoder_pos_embedding(h, "batch" if lengths is None else "single")
        h = self.decoder_transformer(h, _key_mask(lengths, h.shape[1], h.device))
        return h if return_feats else self.vertice_map_reverse(h)


class VQAutoEncoder(nn.Module):
    """Listener / speaker motion VQ-VAE.

    ``variant='BIWI'`` has the pre/post linear embeddings and an unbiased
    output projection; ``variant='vocaset'`` has neither embedding, a biased
    output projection, and subtracts a face template before the encoder and
    adds it back after the decoder in ``forward`` (stage1_vocaset.py:42-52).
    ``with_decoder=False`` builds the encoder and codebook only: SLMFT's
    speaker tokenizer never decodes, and the JAX package's param tree holds
    no decoder for it, so neither does this module (strict loads stay
    possible)."""

    def __init__(self, cfg, with_decoder: bool = True, variant: str = "BIWI"):
        super().__init__()
        if variant not in ("BIWI", "vocaset"):
            raise ValueError(f"unknown VQ variant {variant!r}")
        biwi = variant == "BIWI"
        self.variant = variant
        self.face_quan_num = cfg.face_quan_num
        self.zquant_dim = cfg.zquant_dim
        self.encoder = TransformerEncoder(cfg, project_to_quant=biwi)
        if with_decoder:
            self.decoder = TransformerDecoder(cfg, cfg.in_dim, project_from_quant=biwi,
                                              out_bias=not biwi)
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

    def decode_feats(self, quant: torch.Tensor) -> torch.Tensor:
        """(B, zquant_dim, L*fq) latents -> the decoder transformer's (B, L,
        hidden) features, before the output projection."""
        b = quant.shape[0]
        h = quant.transpose(1, 2).reshape(b, -1, self.face_quan_num * self.zquant_dim)
        return self.decoder(h, return_feats=True)

    def forward(self, x: torch.Tensor, template: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, VQEncodeResult]:
        """The training pass: (reconstruction, quantization loss, encode
        result). The vocaset variant takes the (B, in_dim) ``template``."""
        if self.variant == "vocaset":
            if template is None:
                raise ValueError("the vocaset variant needs a template")
            x = x - template[:, None, :]
        enc = self.encode(x)
        dec = self.decode(enc.quant)
        if self.variant == "vocaset":
            dec = dec + template[:, None, :]
        return dec, enc.emb_loss, enc

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

    def decode_logit(self, logits: torch.Tensor, zshape: Tuple[int, int, int]
                     ) -> torch.Tensor:
        """(B, N, n_embed) logits -> their top-1 codes -> motion; a 2-D input
        is taken as the codes themselves (stage1_BIWI.py:108-116)."""
        ix = torch.softmax(logits, dim=-1).argmax(dim=-1) if logits.dim() == 3 else logits
        return self.decode_to_img(ix.reshape(-1, 1), zshape)


def get_logit(logits: torch.Tensor, sample: bool = True, temperature: float = 0.7,
              top_p: float = 0.9, generator: Optional[torch.Generator] = None,
              gumbel: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Code indices (B, N) and probabilities (B, N, E) from (B, N, n_embed)
    logits (stage1_BIWI.py:118-137), with the reference's quirks: ``top_p``
    is never applied and the temperature is 0.7. ``sample`` draws from the
    categorical by Gumbel-max, the draw of ``jax.random.categorical``: the
    argmax of log(probs) plus Gumbel noise, the noise injected as ``gumbel``
    (same shape as ``logits``) or drawn from ``generator``. Without
    ``sample`` the argmax."""
    del top_p  # accepted and unused, as in the reference
    probs = torch.softmax(logits / temperature, dim=-1)
    if not sample:
        return probs.argmax(dim=-1), probs
    if gumbel is None:
        gumbel = gumbel_noise(probs.shape, generator, probs.device)
    return (torch.log(probs.clamp_min(1e-38)) + gumbel).argmax(dim=-1), probs


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

