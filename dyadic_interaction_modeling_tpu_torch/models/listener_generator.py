"""The seq2seq listener generator without pretraining, and its baselines.

Counterpart of ``dyadic_interaction_modeling_tpu/models/listener_generator.py``
(the reference's ``seq2seq.py``):

* ``Seq2SeqTransformer`` (JAX :42, seq2seq.py:13-74): a continuous encoder
  and a token decoder; the listener-id row, when given, is prepended to the
  encoder output, with a True column before the key mask and a -100 before
  the targets, and the logits lose that row again;
* ``ContinuousSeq2Seq`` (JAX :81, seq2seq.py:76-135): a continuous encoder
  and a non-causal continuous "decoder" over ``enc[:, :-1]`` with the key
  mask ``mask[:, :-1]``, and the masked MSE against ``tgt[:, 1:]``; its
  input width is explicit (``dim_in``), where flax infers it;
* ``ListenerGenerator`` (JAX :115, seq2seq.py:138-290): the frozen speaker
  VQ's quantized features as the encoder input (0 past each clip) and the
  frozen listener VQ's codes as targets (-100 past it), optional speaker and
  listener id embeddings, CE plus the continuous loss of the VQ-decoded
  argmax;
* ``SimpleLSTM`` (JAX :220, seq2seq.py:292-309): the BiLSTM baseline.

Each module holds the parameters of the JAX package's tree, under the
reference's keys: ``speaker_vq.`` (encoder and quantizer; no forward
decodes with it), ``listener_vq.``, ``generator.encoder.``,
``generator.decoder.net.``, and with ``with_ids`` the id embeddings and
``fc_speaker`` / ``fc_listener``, which flax creates only when ids are
passed. A reference file also holds the speaker VQ's decoder
(``LG_REFERENCE_ONLY``, dropped by name on load).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn import LSTM
from .slm import _ARWrapper, continuous_loss
from .vq_vae import VQAutoEncoder
from .xtrans import (
    IGNORE,
    ContinuousTransformerWrapper,
    TokenDecoder,
    ar_cross_entropy,
    ar_inputs_targets,
)

# the frozen parts (seq2seq.py:164-175, ``LG_FROZEN`` of the JAX
# cli/train_s2s.py:24): the speaker VQ whole, the listener VQ's encoder and
# quantizer; module-name prefixes of the port
LG_FROZEN = ("speaker_vq", "listener_vq.quantize", "listener_vq.encoder")
# what a reference file holds that no forward touches
LG_REFERENCE_ONLY = ("speaker_vq.decoder.",)
# the id conditioning, present only in a model built ``with_ids``
LG_ID_PARTS = ("speaker_embeddings.", "listener_embeddings.", "fc_speaker.", "fc_listener.")


class Seq2SeqTransformer(nn.Module):
    """Continuous encoder -> token decoder (seq2seq.py:13-74)."""

    def __init__(self, cfg, dim_in: int):
        super().__init__()
        self.encoder = ContinuousTransformerWrapper(dim_in, cfg.dim, cfg.enc_max_seq_len,
                                                    cfg.enc_depth, cfg.enc_heads)
        self.decoder = _ARWrapper(TokenDecoder(cfg.dec_num_tokens, cfg.dim,
                                               cfg.dec_max_seq_len, cfg.dec_depth,
                                               cfg.dec_heads))

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                listener_ids_decoded: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(CE, logits) of teacher-forced decoding of the codes ``tgt``
        (B, L) against the encoded ``src`` (B, Ls, dim_in)."""
        enc = self.encoder(src, mask=mask)
        if listener_ids_decoded is not None:
            # the listener context row goes first (seq2seq.py:50-58)
            b = tgt.shape[0]
            enc = torch.cat([listener_ids_decoded[:, None, :].to(enc.dtype), enc], dim=1)
            if mask is not None:
                mask = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=mask.device),
                                  mask], dim=1)
            tgt = torch.cat([torch.full((b, 1), IGNORE, dtype=tgt.dtype, device=tgt.device),
                             tgt], dim=1)
        inp, targets = ar_inputs_targets(tgt)
        logits = self.decoder.net(inp, context=enc, context_mask=mask)
        loss = ar_cross_entropy(logits, targets)
        if listener_ids_decoded is not None:
            logits = logits[:, 1:]
        return loss, logits


class ContinuousSeq2Seq(nn.Module):
    """Continuous encoder-decoder with the masked MSE of the next frame
    (seq2seq.py:76-135)."""

    def __init__(self, cfg, dim_in: int, out_dim: int = 56):
        super().__init__()
        self.encoder = ContinuousTransformerWrapper(dim_in, cfg.dim, cfg.enc_max_seq_len,
                                                    cfg.enc_depth, cfg.enc_heads)
        # the reference's "decoder" is a continuous wrapper reading the
        # encoder output directly (seq2seq.py:104-110)
        self.decoder = ContinuousTransformerWrapper(cfg.dim, cfg.dim, cfg.enc_max_seq_len,
                                                    cfg.dec_depth, cfg.dec_heads,
                                                    dim_out=out_dim)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        enc = self.encoder(src, mask=mask)
        pred = self.decoder(enc[:, :-1], mask=None if mask is None else mask[:, :-1])
        se = (pred - tgt[:, 1:].to(pred.dtype)).square()
        if mask is None:
            return se.mean()
        m = mask[:, 1:, None].to(se.dtype)
        return (se * m).sum() / (m.sum() * se.shape[-1]).clamp_min(1.0)


class LGOutputs(NamedTuple):
    loss: torch.Tensor
    pred_cont_seq: torch.Tensor


class ListenerGenerator(nn.Module):
    """Frozen-VQ seq2seq listener generator (seq2seq.py:138-290).

    ``speaker_feature_layout``: ``"reference"`` (the default) reproduces the
    reference's ``.view`` of the (B, zq, L*fq) quantized speaker features as
    (B, L, fq*zq) without a transpose (seq2seq.py:227-228), the row order
    that reference-trained encoder weights expect; ``"frames"`` is the clean
    per-frame layout."""

    def __init__(self, cfg, vq_cfg_speaker, vq_cfg_listener, with_ids: bool = True,
                 speaker_feature_layout: str = "reference"):
        super().__init__()
        if cfg.dec_num_tokens != vq_cfg_listener.n_embed:
            raise ValueError(f"decoder vocab ({cfg.dec_num_tokens}) must equal the listener "
                             f"VQ codebook size ({vq_cfg_listener.n_embed})")
        if speaker_feature_layout not in ("reference", "frames"):
            raise ValueError(f"unknown speaker_feature_layout {speaker_feature_layout!r}")
        self.cfg, self.vq_cfg_speaker = cfg, vq_cfg_speaker
        self.speaker_feature_layout = speaker_feature_layout
        self.speaker_vq = VQAutoEncoder(vq_cfg_speaker, with_decoder=False)
        self.listener_vq = VQAutoEncoder(vq_cfg_listener)
        sp = vq_cfg_speaker
        self.generator = Seq2SeqTransformer(cfg, sp.face_quan_num * sp.zquant_dim)
        if with_ids:
            self.speaker_embeddings = nn.Embedding(cfg.num_identities, cfg.id_embed_dim)
            self.listener_embeddings = nn.Embedding(cfg.num_identities, cfg.id_embed_dim)
            self.fc_speaker = nn.Linear(cfg.id_embed_dim, cfg.enc_max_seq_len)
            self.fc_listener = nn.Linear(cfg.id_embed_dim, cfg.dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.generator.encoder.project_in.weight.dtype

    @torch.no_grad()
    def _encode_streams(self, v_speaker: torch.Tensor, v_listener: torch.Tensor,
                        mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batched equivalent of the per-sample VQ loops (seq2seq.py:216-223):
        the speaker's quantized features (B, L, fq*zq), 0 past each clip, and
        the listener's codes (B, L), -100 past it."""
        lengths = mask.sum(dim=1).to(torch.int32)
        fq, zq = self.vq_cfg_speaker.face_quan_num, self.vq_cfg_speaker.zquant_dim
        quant = self.speaker_vq.encode(v_speaker.to(self.dtype), lengths).quant  # (B, zq, L*fq)
        b = quant.shape[0]
        if self.speaker_feature_layout == "reference":
            # zeros past the clip on the last axis, then the contiguous
            # (B, zq, L*fq) memory read as (B, L, fq*zq): a reinterpretation,
            # not a transpose (seq2seq.py:220-228)
            valid = (torch.arange(quant.shape[-1], device=quant.device)[None, :]
                     < (lengths * fq)[:, None])
            quant = torch.where(valid[:, None, :], quant, 0.0).contiguous()
        else:  # "frames": each frame's fq codes' features side by side
            quant = quant.transpose(1, 2)
            valid = (torch.arange(quant.shape[1], device=quant.device)[None, :]
                     < (lengths * fq)[:, None])
            quant = torch.where(valid[:, :, None], quant, 0.0)
        x_speaker = quant.reshape(b, -1, fq * zq)
        idx_l = self.listener_vq.encode_indices(v_listener.to(self.dtype), lengths)
        pos = torch.arange(idx_l.shape[1], device=idx_l.device)[None, :]
        return x_speaker, torch.where(pos < lengths[:, None], idx_l, IGNORE)

    def forward(self, v_speaker: torch.Tensor, v_listener: torch.Tensor, mask: torch.Tensor,
                speaker_ids: Optional[torch.Tensor] = None,
                listener_ids: Optional[torch.Tensor] = None) -> LGOutputs:
        """Loss (CE + continuous loss) and the VQ-decoded argmax (B, L-1, 56)."""
        x_speaker, z_listener = self._encode_streams(v_speaker, v_listener, mask)
        mask_updated = mask
        if speaker_ids is not None:
            # ids projected to enc_max_seq_len and sliced to the input width,
            # the first encoder row (seq2seq.py:230-232)
            sp_dec = self.fc_speaker(F.relu(self.speaker_embeddings(speaker_ids.long())))
            x_speaker = torch.cat([sp_dec[:, None, : x_speaker.shape[-1]], x_speaker], dim=1)
            mask_updated = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1)
        li_dec = None
        if listener_ids is not None:
            li_dec = self.fc_listener(F.relu(self.listener_embeddings(listener_ids.long())))
        loss, logits = self.generator(x_speaker, z_listener, mask_updated, li_dec)
        pred_cont_seq = self.listener_vq.decode_indices(logits.argmax(dim=-1))
        loss_cont = continuous_loss(pred_cont_seq, v_listener.to(pred_cont_seq.dtype), mask)
        return LGOutputs(loss + loss_cont, pred_cont_seq)

    def encode_context(self, v_speaker: torch.Tensor, v_listener: torch.Tensor,
                       mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(encoder embeddings (B, L, dim), first listener codes (B, 1)) for
        generation (seq2seq.py:266-290)."""
        x_speaker, z_listener = self._encode_streams(v_speaker, v_listener, mask)
        return self.generator.encoder(x_speaker, mask=mask), z_listener[:, :1].clamp(min=0)

    def decode_tokens_to_motion(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.listener_vq.decode_indices(tokens)


class SimpleLSTM(nn.Module):
    """BiLSTM baseline (seq2seq.py:292-309): 3 layers, then a linear head;
    (MSE, prediction)."""

    def __init__(self, in_dim: int = 56 + 768, hidden: int = 256, out_dim: int = 56):
        super().__init__()
        self.model = LSTM(in_dim, hidden, num_layers=3, bidirectional=True)
        self.fc = nn.Linear(2 * hidden, out_dim)

    def forward(self, x: torch.Tensor, x_target: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.fc(self.model(x))
        return (out - x_target).square().mean(), out
