"""SLMFT: listener generation with the SLM stack (seq2seq_pretrain.py:325-514).

Counterpart of ``dyadic_interaction_modeling_tpu/models/slm.py:117-358`` for
the generation path: the frozen VQ tokenizers, the causal speaker encoders
and the decoder context. The module holds exactly the parameters of the JAX
package's SLMFT tree, under the reference state_dict keys, so weights move
between the two with ``load_state_dict(strict=True)``:

* ``speaker_vq`` has no decoder (SLMFT never decodes speaker codes);
* the encoders have no ``project_out`` (they only return embeddings);
* the decoder has no positional embedding (seq2seq_pretrain.py:386);
* there is no ``encoder_l``, ``norm_l`` or ``norm`` (the SLM pretraining
  model's, unused by SLMFT).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .vq_vae import VQAutoEncoder
from .xtrans import ContinuousTransformerWrapper, TokenDecoder

IGNORE = -100


class _ARWrapper(nn.Module):
    """x-transformers AutoregressiveWrapper: holds the decoder as ``.net``."""

    def __init__(self, net: TokenDecoder):
        super().__init__()
        self.net = net


class SLMFT(nn.Module):
    """Listener finetune / eval model."""

    def __init__(self, cfg, vq_cfg):
        super().__init__()
        if cfg.num_tokens != vq_cfg.n_embed:
            raise ValueError(f"decoder vocab ({cfg.num_tokens}) must equal the VQ "
                             f"codebook size ({vq_cfg.n_embed})")
        self.cfg, self.vq_cfg = cfg, vq_cfg
        dh = cfg.get("attn_dim_head", 64)
        kvh = cfg.get("attn_kv_heads", 0) or None
        self.speaker_vq = VQAutoEncoder(vq_cfg, with_decoder=False)
        self.listener_vq = VQAutoEncoder(vq_cfg)
        enc = dict(dim=cfg.dim, max_seq_len=cfg.enc_max_seq_len,
                   depth=cfg.enc_depth, heads=cfg.enc_heads, dim_head=dh,
                   kv_heads=kvh)
        self.encoder_s = ContinuousTransformerWrapper(cfg.dim_in, **enc)
        self.encoder_joint = ContinuousTransformerWrapper(cfg.dim, **enc)
        self.patch_embed_s = nn.Parameter(torch.zeros(1, 1, cfg.dim_in))
        self.patch_embed_l = nn.Parameter(torch.zeros(1, 1, cfg.dim_in))
        self.patch_embed_dec_s = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.patch_embed_dec_l = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.norm_s = nn.LayerNorm(cfg.dim, eps=1e-6)  # flax's default eps
        self.decoder_joint = _ARWrapper(TokenDecoder(
            num_tokens=cfg.num_tokens, dim=cfg.dim + cfg.dim_audio,
            max_seq_len=cfg.dec_max_seq_len, depth=cfg.dec_depth,
            heads=cfg.dec_heads, dim_head=dh, use_abs_pos_emb=False,
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
