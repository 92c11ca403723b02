"""The SLM family: dyadic pretraining (SLM) and listener generation (SLMFT).

Counterpart of ``dyadic_interaction_modeling_tpu/models/slm.py:57-358``
(seq2seq_pretrain.py:72-514): the frozen VQ tokenizers, the continuous
encoders, the cross-predicting token decoder and the training losses: SLM's
pretraining and SLMFT's listener finetune. Each module holds exactly the parameters of the JAX package's tree,
under the reference state_dict keys, so weights move between the two with
``load_state_dict(strict=True)``. Shared by both (``_SLMBase``): the speaker
and listener VQs, ``encoder_s``, ``encoder_joint``, the four patch
embeddings, ``norm_s`` and ``decoder_joint``. The encoders have no
``project_out`` (they only return embeddings). SLM adds:

* ``encoder_l``, ``norm_l`` and ``norm``;
* the speaker VQ's decoder (SLMFT never decodes speaker codes);
* the decoder's positional embedding (SLMFT's has none,
  seq2seq_pretrain.py:386).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..metrics.loss import pairwise_distance_loss
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
    """The stack both models share (seq2seq_pretrain.py:116-165);
    ``pretrain`` adds SLM's parts (module docstring)."""

    def __init__(self, cfg, vq_cfg, pretrain: bool):
        super().__init__()
        if cfg.num_tokens != vq_cfg.n_embed:
            raise ValueError(f"decoder vocab ({cfg.num_tokens}) must equal the VQ "
                             f"codebook size ({vq_cfg.n_embed})")
        self.cfg, self.vq_cfg = cfg, vq_cfg
        dh = cfg.get("attn_dim_head", 64)
        kvh = cfg.get("attn_kv_heads", 0) or None
        self.speaker_vq = VQAutoEncoder(vq_cfg, with_decoder=pretrain)
        self.listener_vq = VQAutoEncoder(vq_cfg)
        enc = dict(dim=cfg.dim, max_seq_len=cfg.enc_max_seq_len,
                   depth=cfg.enc_depth, heads=cfg.enc_heads, dim_head=dh,
                   kv_heads=kvh)
        self.encoder_s = ContinuousTransformerWrapper(cfg.dim_in, **enc)
        if pretrain:
            self.encoder_l = ContinuousTransformerWrapper(cfg.dim_in, **enc)
        self.encoder_joint = ContinuousTransformerWrapper(cfg.dim, **enc)
        self.patch_embed_s = nn.Parameter(torch.zeros(1, 1, cfg.dim_in))
        self.patch_embed_l = nn.Parameter(torch.zeros(1, 1, cfg.dim_in))
        self.patch_embed_dec_s = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.patch_embed_dec_l = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.norm_s = nn.LayerNorm(cfg.dim, eps=1e-6)  # flax's default eps
        if pretrain:
            self.norm_l = nn.LayerNorm(cfg.dim, eps=1e-6)
            self.norm = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.decoder_joint = _ARWrapper(TokenDecoder(
            num_tokens=cfg.num_tokens, dim=cfg.dim + cfg.dim_audio,
            max_seq_len=cfg.dec_max_seq_len, depth=cfg.dec_depth,
            heads=cfg.dec_heads, dim_head=dh, use_abs_pos_emb=pretrain,
            kv_heads=kvh))

    @property
    def dtype(self) -> torch.dtype:
        return self.patch_embed_s.dtype

    @property
    def decoder(self) -> TokenDecoder:
        return self.decoder_joint.net

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


class SLM(_SLMBase):
    """Dyadic masked pretraining model (seq2seq_pretrain.py:72-323)."""

    def __init__(self, cfg, vq_cfg):
        super().__init__(cfg, vq_cfg, pretrain=True)

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
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> SLMOutputs:
        """Total loss and the six logs of one batch.

        ``noise``: the (speaker, listener) pair of uniform (B, L) masking
        noise; drawn from ``generator`` when absent."""
        with torch.no_grad():  # stop_gradient (slm.py:261)
            z_s, z_l = self.forward_vq(v_speaker, v_listener, valid_mask)
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
        super().__init__(cfg, vq_cfg, pretrain=False)

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
                noise: Optional[torch.Tensor] = None) -> SLMOutputs:
        """The finetune loss (listener CE + continuous loss), SLM's six logs
        (the speaker and contrastive ones 0) and the teacher-forced motion.

        ``noise``: the standard-normal (B, L-1) noise that picks the
        corrupted inputs; drawn from ``generator`` when absent. The
        corruption applies in evaluation too, as the JAX package's
        ``evaluate_finetune_epoch`` passes an rng and x-transformers applies
        ``mask_prob`` whatever the mode."""
        with torch.no_grad():  # stop_gradient (slm.py:338)
            _, z_l = self.forward_vq(v_speaker, v_listener, valid_mask)
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
