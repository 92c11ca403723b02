"""The SLM family: dyadic pretraining (SLM), listener generation (SLMFT),
BIWI speaker generation (SpeakerSLMFT) and the EMOCA-to-mesh converter.

Counterpart of ``dyadic_interaction_modeling_tpu/models/slm.py:57-583``
(seq2seq_pretrain.py:72-842): the frozen VQ tokenizers, the continuous
encoders, the cross-predicting token decoder, the mesh heads and the
training losses. Each module holds exactly the parameters of the JAX
package's tree (flax creates only what a forward touches), under the
reference state_dict keys, so weights move between the two with
``load_state_dict(strict=True)``. Shared by all three token models
(``_SLMBase``): the speaker and listener VQs' encoders and codebooks, the
four patch embeddings and ``decoder_joint``. The encoders have no
``project_out`` (they only return embeddings). The parts each model adds:

* SLM: ``encoder_s``, ``encoder_l``, ``encoder_joint``, ``norm_s``,
  ``norm_l``, ``norm``, both VQ decoders, the decoder's positional
  embedding;
* SLMFT: ``encoder_s``, ``encoder_joint``, ``norm_s``, the listener VQ's
  decoder; no decoder positions (seq2seq_pretrain.py:386);
* SpeakerSLMFT: no encoder, the speaker VQ's decoder, the decoder's
  positions, the converter front-end, one BiLSTM mesh head, the speaker
  embedding and the unused ``W``. A reference file also holds the
  encoders, norms, the listener VQ's decoder and a second mesh head, which
  no forward touches (``SPEAKER_SLMFT_REFERENCE_ONLY``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..metrics.loss import pairwise_distance_loss
from ..ops.convseq import ConvSquasher
from ..ops.rnn import LSTM
from .vq_vae import VQAutoEncoder
from .xtrans import (
    IGNORE,
    ContinuousTransformerWrapper,
    TokenDecoder,
    ar_cross_entropy,
    ar_inputs_targets,
    ar_mask_prob_kv_mask,
)

# SLM's frozen parameters (seq2seq_pretrain.py:100-113): the VQ quantizers
# and encoders; the VQ decoders train. Module-name prefixes of the port.
SLM_FROZEN = ("speaker_vq.quantize", "speaker_vq.encoder",
              "listener_vq.quantize", "listener_vq.encoder")
# SLMFT's (seq2seq_pretrain.py:352-366): both VQs whole
SLMFT_FROZEN = ("speaker_vq", "listener_vq")
# what an SLM state_dict holds that SLMFT has no module for; dropped by name
# when a pretrained SLM is grafted into SLMFT (``utils.checkpoint.partial_load``)
SLM_ONLY = ("encoder_l.", "norm_l.", "norm.", "speaker_vq.decoder.",
            "decoder_joint.net.pos_emb.")
# SpeakerSLMFT's (seq2seq_pretrain.py:540-573): the listener VQ, the speaker
# VQ's quantizer and encoder, the converter front-end; the speaker VQ's
# decoder, the decoder, the mesh head and the speaker embedding train
SPEAKER_SLMFT_FROZEN = ("listener_vq", "speaker_vq.quantize", "speaker_vq.encoder",
                        "vertice_mapping", "squasher")
# EmocaConverter's (seq2seq_pretrain.py:777-779): the speaker VQ whole
CONVERTER_FROZEN = ("speaker_vq",)
# what a reference SpeakerSLMFT / EmocaConverter file holds that no forward
# touches, so neither the JAX package's tree nor the port's module has it;
# dropped by name on load (the JAX importer drops them by its template,
# utils/torch_import.py:306-375)
SPEAKER_SLMFT_REFERENCE_ONLY = (
    "encoder_s.", "encoder_l.", "encoder_joint.", "norm_s.", "norm_l.", "norm.",
    "listener_vq.decoder.", "vertice_map_reverse_lstm_2.", "vertice_map_reverse2.")
CONVERTER_REFERENCE_ONLY = ("vertice_mapping.", "squasher.",
                            "vertice_map_reverse_lstm_2.", "vertice_map_reverse2.")
# the fraction of decoder inputs the finetune corrupts (the
# AutoregressiveWrapper's mask_prob, seq2seq_pretrain.py:386)
AR_MASK_PROB = 0.15


def random_masking_unstructured(noise: torch.Tensor, valid_mask: torch.Tensor,
                                mask_ratio: float) -> torch.Tensor:
    """Per row, the ``floor(len * ratio)`` valid positions of lowest uniform
    ``noise`` (B, L): bool (B, L), True = masked (seq2seq_pretrain.py:171-183)."""
    noise = torch.where(valid_mask, noise, float("inf"))
    order = torch.argsort(noise, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    k = (valid_mask.sum(dim=1) * mask_ratio).to(torch.int32)
    return ranks < k[:, None]


def masked_mean(x: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """Mean over the valid frames of each sample: (B, L, D) -> (B, D)."""
    m = valid_mask.to(x.dtype)[:, :, None]
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


def info_nce(s_rep: torch.Tensor, l_rep: torch.Tensor, valid_mask: torch.Tensor,
             temp: float = 0.05) -> Tuple[torch.Tensor, torch.Tensor]:
    """InfoNCE between the masked-mean speaker and listener representations,
    and its accuracy (seq2seq_pretrain.py:270-298)."""
    s = masked_mean(s_rep, valid_mask)
    l = masked_mean(l_rep, valid_mask)
    s = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True).clamp_min(1e-12)
    l = l / torch.linalg.vector_norm(l, dim=-1, keepdim=True).clamp_min(1e-12)
    total = (s @ l.T) / temp
    nce = -torch.diagonal(torch.log_softmax(total, dim=0)).mean()
    pred = torch.softmax(total, dim=0).argmax(dim=0)
    c_acc = (pred == torch.arange(total.shape[0], device=pred.device)).float().mean()
    return nce, c_acc


def continuous_loss(pred: torch.Tensor, target: torch.Tensor,
                    frame_mask: torch.Tensor) -> torch.Tensor:
    """Masked pose/expression distance of VQ-decoded frames ``pred``
    (B, Lp, C) to ``target`` (B, L, C) without its frame 0
    (seq2seq_pretrain.py:256-268)."""
    target, mask = target[:, 1:], frame_mask[:, 1:]
    lp = min(pred.shape[1], target.shape[1])
    c = pred.shape[-1]
    return pairwise_distance_loss(pred[:, :lp].reshape(-1, c),
                                  target[:, :lp].reshape(-1, c),
                                  mask[:, :lp].reshape(-1))


class SLMOutputs(NamedTuple):
    total_loss: torch.Tensor
    logs: Dict[str, torch.Tensor]
    pred: Optional[torch.Tensor] = None  # SLMFT: teacher-forced motion (B, L-1, 56)


class _ARWrapper(nn.Module):
    """x-transformers AutoregressiveWrapper: holds the decoder as ``.net``."""

    def __init__(self, net: TokenDecoder):
        super().__init__()
        self.net = net


class _SLMBase(nn.Module):
    """The stack the models share (seq2seq_pretrain.py:116-165), holding
    only the parts a model's forward touches (module docstring):
    ``encoders`` (those of ``encoder_s``, ``encoder_l``, ``encoder_joint``),
    ``norms`` (of ``norm_s``, ``norm_l``, ``norm``), the VQ decoders
    (``speaker_decoder``, ``listener_decoder``) and the decoder's absolute
    positions (``dec_pos_emb``)."""

    def __init__(self, cfg, vq_cfg, *, encoders: Tuple[str, ...] = (),
                 norms: Tuple[str, ...] = (), speaker_decoder: bool = False,
                 listener_decoder: bool = False, dec_pos_emb: bool = False):
        super().__init__()
        if cfg.num_tokens != vq_cfg.n_embed:
            raise ValueError(f"decoder vocab ({cfg.num_tokens}) must equal the VQ "
                             f"codebook size ({vq_cfg.n_embed})")
        self.cfg, self.vq_cfg = cfg, vq_cfg
        dh = cfg.get("attn_dim_head", 64)
        kvh = cfg.get("attn_kv_heads", 0) or None
        self.speaker_vq = VQAutoEncoder(vq_cfg, with_decoder=speaker_decoder)
        self.listener_vq = VQAutoEncoder(vq_cfg, with_decoder=listener_decoder)
        enc = dict(dim=cfg.dim, max_seq_len=cfg.enc_max_seq_len,
                   depth=cfg.enc_depth, heads=cfg.enc_heads, dim_head=dh,
                   kv_heads=kvh)
        for name in encoders:
            dim_in = cfg.dim if name == "encoder_joint" else cfg.dim_in
            setattr(self, name, ContinuousTransformerWrapper(dim_in, **enc))
        self.patch_embed_s = nn.Parameter(torch.zeros(1, 1, cfg.dim_in))
        self.patch_embed_l = nn.Parameter(torch.zeros(1, 1, cfg.dim_in))
        self.patch_embed_dec_s = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.patch_embed_dec_l = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        for name in norms:
            setattr(self, name, nn.LayerNorm(cfg.dim, eps=1e-6))  # flax's default eps
        self.decoder_joint = _ARWrapper(TokenDecoder(
            num_tokens=cfg.num_tokens, dim=cfg.dim + cfg.dim_audio,
            max_seq_len=cfg.dec_max_seq_len, depth=cfg.dec_depth,
            heads=cfg.dec_heads, dim_head=dh, use_abs_pos_emb=dec_pos_emb,
            kv_heads=kvh))

    @property
    def dtype(self) -> torch.dtype:
        return self.patch_embed_s.dtype

    @property
    def decoder(self) -> TokenDecoder:
        return self.decoder_joint.net

    @torch.no_grad()  # stop_gradient (slm.py:261, :338)
    def _tokens(self, v_speaker, v_listener, valid_mask):
        return self.forward_vq(v_speaker, v_listener, valid_mask)

    def forward_vq(self, v_speaker: torch.Tensor, v_listener: torch.Tensor,
                   valid_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched masked tokenization: speaker codes padded with 0 and
        listener codes with -100 past each clip's length."""
        lengths = valid_mask.sum(dim=1).to(torch.int32)
        fq = self.vq_cfg.face_quan_num
        idx_s = self.speaker_vq.encode_indices(v_speaker.to(self.dtype), lengths)
        idx_l = self.listener_vq.encode_indices(v_listener.to(self.dtype), lengths)
        pos_s = torch.arange(idx_s.shape[1], device=idx_s.device)[None, :]
        pos_l = torch.arange(idx_l.shape[1], device=idx_l.device)[None, :]
        z_s = torch.where(pos_s < (lengths * fq)[:, None], idx_s, 0)
        z_l = torch.where(pos_l < lengths[:, None], idx_l, IGNORE)
        return z_s, z_l

    # --- streaming decode (serving/ drives these; ``slm.py:176-186``) ---

    def stream_cross_kv(self, ctx_chunk: torch.Tensor
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each decoder layer's cross-attention (k, v) of a context chunk:
        linear per position, so appending chunks equals ``cross_kv`` of the
        whole context."""
        return self.decoder.cross_kv(ctx_chunk)

    def stream_decode_step(self, token: torch.Tensor, cache: Dict[str, torch.Tensor], t,
                           cross_kv, context_mask: Optional[torch.Tensor]) -> torch.Tensor:
        return self.decoder.decode_step(token, cache, t, cross_kv, context_mask)


class SLM(_SLMBase):
    """Dyadic masked pretraining model (seq2seq_pretrain.py:72-323)."""

    def __init__(self, cfg, vq_cfg):
        super().__init__(cfg, vq_cfg, encoders=("encoder_s", "encoder_l", "encoder_joint"),
                         norms=("norm_s", "norm_l", "norm"), speaker_decoder=True,
                         listener_decoder=True, dec_pos_emb=True)

    def forward_encoder(self, v_speaker, v_listener, valid_mask, noise_s, noise_l):
        """Mask 15% of each stream's valid frames, encode both streams, then
        the 2L joint pass and the two marginal joint passes, batched as one
        (seq2seq_pretrain.py:201-223)."""
        ratio = self.cfg.mask_ratio
        mask_speaker = random_masking_unstructured(noise_s, valid_mask, ratio)
        mask_listener = random_masking_unstructured(noise_l, valid_mask, ratio)
        v_s = (v_speaker + self.patch_embed_s).masked_fill(mask_speaker[:, :, None], 0.0)
        v_l = (v_listener + self.patch_embed_l).masked_fill(mask_listener[:, :, None], 0.0)
        x_s = self.encoder_s(v_s, mask=valid_mask)
        x_l = self.encoder_l(v_l, mask=valid_mask)
        x_joint = self.encoder_joint(torch.cat([x_s, x_l], dim=1),
                                     mask=torch.cat([valid_mask, valid_mask], dim=1))
        b = x_l.shape[0]
        y = self.encoder_joint(torch.cat([x_l, x_s], dim=0),
                               mask=torch.cat([valid_mask, valid_mask], dim=0))
        x_l, x_s = y[:b], y[b:]
        return (self.norm_s(x_s), self.norm_l(x_l), self.norm(x_joint),
                mask_speaker, mask_listener)

    def forward_decoder(self, x_s, x_l, z_s, z_l, x_a, valid_mask):
        """Cross-prediction, both directions in one batched pass of the shared
        decoder: speaker codes from the listener stream and the reverse
        (seq2seq_pretrain.py:225-239)."""
        x_s = torch.cat([x_s + self.patch_embed_dec_s, x_a.to(x_s.dtype)], dim=-1)
        x_l = torch.cat([x_l + self.patch_embed_dec_l, x_a.to(x_l.dtype)], dim=-1)
        inp_s, tgt_s = ar_inputs_targets(z_s)
        inp_l, tgt_l = ar_inputs_targets(z_l)
        b = inp_s.shape[0]
        px = self.decoder(torch.cat([inp_s, inp_l], dim=0),
                          context=torch.cat([x_l, x_s], dim=0),
                          context_mask=torch.cat([valid_mask, valid_mask], dim=0))
        px_s, px_l = px[:b], px[b:]
        return ar_cross_entropy(px_s, tgt_s), ar_cross_entropy(px_l, tgt_l), px_s, px_l

    def forward_vq_decoder(self, logits_s, logits_l):
        """Argmax codes decoded without lengths, so row b of the batch gets
        positional encoding b (the reference quirk, as the JAX package)."""
        return (self.speaker_vq.decode_indices(logits_s.argmax(dim=-1)),
                self.listener_vq.decode_indices(logits_l.argmax(dim=-1)))

    def forward(self, v_speaker: torch.Tensor, v_listener: torch.Tensor,
                v_audio: torch.Tensor, valid_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                vq_tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> SLMOutputs:
        """Total loss and the six logs of one batch.

        ``noise``: the (speaker, listener) pair of uniform (B, L) masking
        noise; drawn from ``generator`` when absent. ``vq_tokens``: the
        (z_s, z_l) that ``forward_vq`` would give, precomputed (the frozen
        tokenizers give the same codes every step; ``engine.pt_engine.
        VQTokenCache``), so the two VQ encoders do not run."""
        z_s, z_l = vq_tokens if vq_tokens is not None else self._tokens(
            v_speaker, v_listener, valid_mask)
        if noise is None:
            shape, dev = valid_mask.shape, valid_mask.device
            noise = (torch.rand(shape, generator=generator, device=dev),
                     torch.rand(shape, generator=generator, device=dev))
        v_speaker, v_listener = v_speaker.to(self.dtype), v_listener.to(self.dtype)
        x_s, x_l, x_joint, mask_speaker, mask_listener = self.forward_encoder(
            v_speaker, v_listener, valid_mask, *noise)
        nce, c_acc = info_nce(x_s, x_l, valid_mask, self.cfg.contrastive_temp)
        l = x_s.shape[1]
        # only masked positions remain CE targets (seq2seq_pretrain.py:307-309)
        z_s = torch.where(mask_speaker, z_s, IGNORE)
        z_l = torch.where(mask_listener, z_l, IGNORE)
        l_ce_s, l_ce_l, px_s, px_l = self.forward_decoder(
            x_joint[:, :l], x_joint[:, l:], z_s, z_l, v_audio, valid_mask)
        pred_s, pred_l = self.forward_vq_decoder(px_s, px_l)
        l_cont_s = continuous_loss(pred_s, v_speaker, mask_speaker)
        l_cont_l = continuous_loss(pred_l, v_listener, mask_listener)
        total = l_ce_s + l_ce_l + l_cont_s + l_cont_l + nce
        logs = {"l_ce_s": l_ce_s, "l_ce_l": l_ce_l, "l_cont_s": l_cont_s,
                "l_cont_l": l_cont_l, "nce": nce, "c_acc": c_acc}
        return SLMOutputs(total, logs)


class SLMFT(_SLMBase):
    """Listener finetune and eval model (seq2seq_pretrain.py:325-514): the
    teacher-forced finetune (``forward``) and the generation side."""

    def __init__(self, cfg, vq_cfg):
        super().__init__(cfg, vq_cfg, encoders=("encoder_s", "encoder_joint"),
                         norms=("norm_s",), listener_decoder=True)

    def forward_encoder(self, v_speaker: torch.Tensor,
                        valid_mask: torch.Tensor) -> torch.Tensor:
        """Causal speaker encoding (triangular attn_mask)."""
        l = v_speaker.shape[1]
        v_speaker = v_speaker.to(self.dtype)
        attn_mask = torch.ones(l, l, dtype=torch.bool, device=v_speaker.device).tril()
        x_s = self.encoder_s(v_speaker + self.patch_embed_s.to(v_speaker.dtype),
                             mask=valid_mask, attn_mask=attn_mask)
        x_s = self.encoder_joint(x_s, mask=valid_mask, attn_mask=attn_mask)
        return self.norm_s(x_s)

    def decoder_context(self, x_s: torch.Tensor, x_a: torch.Tensor) -> torch.Tensor:
        return torch.cat([x_s + self.patch_embed_dec_s.to(x_s.dtype),
                          x_a.to(x_s.dtype)], dim=-1)

    def decode_train(self, x_s, z_l, x_a, valid_mask, noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decoding with the inputs corrupted: AR_MASK_PROB of
        each row's input codes are hidden from the causal self-attention by
        a key mask chosen by standard-normal ``noise`` (B, L-1), drawn from
        ``generator`` when absent. (CE, logits)."""
        inp, tgt = ar_inputs_targets(z_l)
        kv_mask = ar_mask_prob_kv_mask(inp.shape[0], inp.shape[1], AR_MASK_PROB, noise,
                                       generator, inp.device)
        logits = self.decoder(inp, context=self.decoder_context(x_s, x_a),
                              self_key_mask=kv_mask, context_mask=valid_mask)
        return ar_cross_entropy(logits, tgt), logits

    def forward_vq_decoder_train(self, logits_l: torch.Tensor) -> torch.Tensor:
        """Argmax codes decoded without lengths (the reference quirk, as
        ``SLM.forward_vq_decoder``)."""
        return self.listener_vq.decode_indices(logits_l.argmax(dim=-1))

    def forward(self, v_speaker: torch.Tensor, v_listener: torch.Tensor,
                v_audio: torch.Tensor, valid_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                vq_tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> SLMOutputs:
        """The finetune loss (listener CE + continuous loss), SLM's six logs
        (the speaker and contrastive ones 0) and the teacher-forced motion.

        ``noise``: the standard-normal (B, L-1) noise that picks the
        corrupted inputs; drawn from ``generator`` when absent. The
        corruption applies in evaluation too, as the JAX package's
        ``evaluate_finetune_epoch`` passes an rng and x-transformers applies
        ``mask_prob`` whatever the mode. ``vq_tokens``: precomputed codes, as
        in ``SLM.forward``."""
        _, z_l = vq_tokens if vq_tokens is not None else self._tokens(
            v_speaker, v_listener, valid_mask)
        x_s = self.forward_encoder(v_speaker, valid_mask)
        l_ce_l, logits_l = self.decode_train(x_s, z_l, v_audio, valid_mask, noise, generator)
        pred_l = self.forward_vq_decoder_train(logits_l)
        l_cont_l = continuous_loss(pred_l, v_listener.to(self.dtype), valid_mask)
        zero = torch.zeros((), device=valid_mask.device)
        logs = {"l_ce_s": zero, "l_ce_l": l_ce_l, "l_cont_s": zero, "l_cont_l": l_cont_l,
                "nce": zero, "c_acc": zero}
        return SLMOutputs(l_ce_l + l_cont_l, logs, pred_l)

    def encode_context(self, v_speaker, v_listener, v_audio, valid_mask
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(decoder context (B, L, dim + dim_audio), prompt (B, 1)): the
        prompt is the first listener code with the -100 pad clamped to 0."""
        _, z_l = self.forward_vq(v_speaker, v_listener, valid_mask)
        x_s = self.forward_encoder(v_speaker, valid_mask)
        return self.decoder_context(x_s, v_audio), torch.clamp(z_l[:, :1], min=0)

    def decode_tokens_to_motion(self, tokens: torch.Tensor,
                                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.listener_vq.decode_indices(tokens, lengths)

    # --- streaming serving (``serving/streaming.py``, ``serving/pool.py``).
    # The speaker encoders run under a triangular attn_mask, so frame t's
    # encoding never changes as later frames arrive: a KV-cached extension
    # chunk by chunk is exact.

    def encode_context_chunk(self, v_speaker_chunk: torch.Tensor,
                             v_audio_chunk: torch.Tensor,
                             enc_s_cache: Dict[str, torch.Tensor],
                             enc_j_cache: Dict[str, torch.Tensor], t) -> torch.Tensor:
        """A (B, C, dim_in) speaker chunk whose first frame is at ``t`` (int,
        or a (B,) tensor of each row's own) encoded causally against the two
        encoders' KV caches, updated in place: rows [t, t+C) of
        ``decoder_context`` (B, C, dim + dim_audio)."""
        h = v_speaker_chunk.to(self.dtype) + self.patch_embed_s
        x = self.encoder_s.extend(h, enc_s_cache, t)
        x = self.encoder_joint.extend(x, enc_j_cache, t)
        return self.decoder_context(self.norm_s(x), v_audio_chunk)

    def tokenize_listener_frames(self, v_listener: torch.Tensor) -> torch.Tensor:
        """Listener frames -> the listener VQ's codes, clamped at 0 (a
        streaming prompt from the first frames)."""
        return torch.clamp(self.listener_vq.encode_indices(v_listener.to(self.dtype)), min=0)


class MeshHead(nn.Sequential):
    """Linear(768, 768) -> LeakyReLU(0.2) -> Linear(768, vertice_dim)
    (seq2seq_pretrain.py:815-819), keyed ``.0`` and ``.2``."""

    def __init__(self, vertice_dim: int):
        super().__init__(nn.Linear(768, 768), nn.LeakyReLU(0.2),
                         nn.Linear(768, vertice_dim))


def _mesh_heads(module: nn.Module, emoca_dim: int, vertice_dim: int) -> None:
    """The 2-layer BiLSTM(384) and the mesh head that turn EMOCA into a mesh
    (the reference's ``vertice_map_reverse_lstm`` / ``vertice_map_reverse``;
    its second pair is never used)."""
    module.vertice_map_reverse_lstm = LSTM(emoca_dim, 384, num_layers=2, bidirectional=True)
    module.vertice_map_reverse = MeshHead(vertice_dim)


class SpeakerSLMFT(_SLMBase):
    """BIWI speaker finetune and generation (seq2seq_pretrain.py:516-757).

    Inputs: raw BIWI vertices (``vertice_dim``, 70110 = 23370 x 3), EMOCA
    coefficients (56), audio features (768) and the subject's template. The
    frozen converter front-end maps the vertices to 56-d; the decoder
    predicts EMOCA codes autoregressively, conditioned on the speaker
    embedding and the audio, and the BiLSTM mesh head turns decoded EMOCA
    into a mesh.

    Reproduced reference quirks: ``forward_vq`` tokenizes the converted
    vertices with ``speaker_vq`` and the EMOCA with ``listener_vq``, the
    targets are the listener VQ's codes, and they are decoded with
    ``speaker_vq``; the total loss is CE + EMOCA MSE, while the mouth MSE is
    only logged (``l_cont_s``)."""

    def __init__(self, cfg, vq_cfg, vertice_dim: int = 70110, n_speakers: int = 15):
        super().__init__(cfg, vq_cfg, speaker_decoder=True, dec_pos_emb=True)
        self.vertice_mapping = nn.Sequential(nn.Linear(vertice_dim, cfg.dim_in),
                                             nn.LeakyReLU(0.2))
        self.squasher = ConvSquasher(cfg.dim_in, cfg.dim_in, 0, neg=0.2, affine=False)
        _mesh_heads(self, vq_cfg.in_dim, vertice_dim)
        self.speaker_embed = nn.Embedding(n_speakers, cfg.dim)
        self.W = nn.Parameter(torch.randn(2))

    def convert_front(self, verts: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
        """(B, L, vertice_dim) vertices less the (B, vertice_dim) template ->
        (B, L, dim_in) through the converter's front-end."""
        v = (verts - template[:, None, :]).to(self.dtype)
        return self.squasher(self.vertice_mapping(v))

    def mesh_head(self, emoca: torch.Tensor) -> torch.Tensor:
        """(B, L, 56) EMOCA -> (B, L, vertice_dim) mesh offsets."""
        return self.vertice_map_reverse(self.vertice_map_reverse_lstm(emoca))

    def decode_emoca(self, tokens_or_logits: torch.Tensor, from_logits: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Codes (or logits, through their argmax) -> (mesh offsets, EMOCA),
        decoded by the speaker VQ."""
        pred = tokens_or_logits.argmax(dim=-1) if from_logits else tokens_or_logits
        emoca = self.speaker_vq.decode_indices(pred)
        return self.mesh_head(emoca), emoca

    def _context(self, v_audio: torch.Tensor,
                 speaker_ids: Optional[torch.Tensor]) -> torch.Tensor:
        """The decoder's context: the speaker embedding (zeros without ids)
        plus ``patch_embed_dec_l``, beside the audio features."""
        b, l = v_audio.shape[0], v_audio.shape[1]
        if speaker_ids is None:
            x_l = torch.zeros(b, l, self.cfg.dim, dtype=self.dtype, device=v_audio.device)
        else:
            x_l = self.speaker_embed(speaker_ids.long())[:, None, :].expand(b, l, -1)
        return torch.cat([x_l + self.patch_embed_dec_l, v_audio.to(x_l.dtype)], dim=-1)

    def _codes(self, verts, emoca, valid_mask, template) -> torch.Tensor:
        """The listener VQ's EMOCA codes, the targets (no gradient)."""
        with torch.no_grad():
            return self.forward_vq(self.convert_front(verts, template), emoca, valid_mask)[1]

    def forward(self, v_speaker_verts: torch.Tensor, v_speaker_emoca: torch.Tensor,
                v_audio: torch.Tensor, valid_mask: torch.Tensor, template: torch.Tensor,
                speaker_ids: Optional[torch.Tensor] = None, mouth_map=None) -> SLMOutputs:
        """The teacher-forced finetune: CE + EMOCA MSE, SLM's six logs (the
        mouth MSE of the mesh under ``mouth_map`` as ``l_cont_s``, 0 without
        one) and the decoded (B, L-1, 56) EMOCA."""
        z = self._codes(v_speaker_verts, v_speaker_emoca, valid_mask, template)
        inp, tgt = ar_inputs_targets(z)
        logits = self.decoder(inp, context=self._context(v_audio, speaker_ids),
                              context_mask=valid_mask)
        l_ce = ar_cross_entropy(logits, tgt)
        emoca = self.speaker_vq.decode_indices(logits.argmax(dim=-1))
        l_emoca = (emoca - v_speaker_emoca[:, 1:].to(emoca.dtype)).square().mean()
        zero = torch.zeros((), device=valid_mask.device)
        l_mouth = zero
        if mouth_map is not None:
            mesh = self.mesh_head(emoca) + template[:, None, :]
            b, n = mesh.shape[0], mesh.shape[1]
            pred = mesh.reshape(b, n, -1, 3)[:, :, mouth_map]
            gt = v_speaker_verts[:, 1:].reshape(b, n, -1, 3)[:, :, mouth_map]
            l_mouth = (pred - gt.to(pred.dtype)).square().mean()
        logs = {"l_ce_s": zero, "l_ce_l": l_ce, "l_cont_s": l_mouth, "l_cont_l": l_emoca,
                "nce": zero, "c_acc": zero}
        return SLMOutputs(l_ce + l_emoca, logs, emoca)

    def encode_context(self, v_speaker_verts, v_speaker_emoca, v_audio, valid_mask,
                       template, speaker_ids=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(decoder context (B, L, dim + dim_audio), prompt (B, 1)): the
        prompt is the first target code with the -100 pad clamped to 0."""
        z = self.forward_vq(self.convert_front(v_speaker_verts, template),
                            v_speaker_emoca, valid_mask)[1]
        return self._context(v_audio, speaker_ids), torch.clamp(z[:, :1], min=0)

    def tokenize_emoca_frames(self, v_emoca: torch.Tensor) -> torch.Tensor:
        """EMOCA frames -> the speaker VQ's codes, clamped at 0 (a prompt from
        the first frames of a stream)."""
        return torch.clamp(self.speaker_vq.encode_indices(v_emoca.to(self.dtype)), min=0)

    # --- streaming serving (``serving/speaker.py``): a frame's context row is
    # the speaker embedding and that frame's audio, with no temporal mixing

    def stream_speaker_context(self, v_audio_chunk: torch.Tensor,
                               speaker_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decoder-context rows of an audio chunk: those of
        ``encode_context``'s context for the same frames."""
        return self._context(v_audio_chunk, speaker_ids)

    def stream_decode_emoca(self, tokens: torch.Tensor, template: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Codes -> (mesh (B, T, vertice_dim) with the template added, EMOCA
        (B, T, 56)); the BiLSTM head is bidirectional over the prefix, so a
        stream re-decodes a trailing window as codes arrive."""
        mesh, emoca = self.decode_emoca(tokens, from_logits=False)
        return mesh + template[:, None, :].to(mesh.dtype), emoca


class EmocaConverter(nn.Module):
    """EMOCA-56 -> BIWI mesh regressor (seq2seq_pretrain.py:759-842): the
    frozen speaker VQ's round trip, then the 2-layer BiLSTM(384) and the mesh
    head, plus the template. ``cfg`` is the speaker VQ's."""

    def __init__(self, cfg, vertice_dim: int = 70110, emoca_dim: int = 56):
        super().__init__()
        self.speaker_vq = VQAutoEncoder(cfg)
        _mesh_heads(self, emoca_dim, vertice_dim)

    def forward(self, template: torch.Tensor, v_speaker: torch.Tensor) -> torch.Tensor:
        """(B, vertice_dim) template, (B, L, 56) EMOCA -> (B, L, vertice_dim)."""
        dec = self.speaker_vq(v_speaker)[0]
        out = self.vertice_map_reverse(self.vertice_map_reverse_lstm(dec))
        return out + template[:, None, :]
