"""CodeTalker: speech-driven vertex animation, stage 2 (reference
models/stage2.py).

Counterpart of ``dyadic_interaction_modeling_tpu/models/codetalker.py``:
the wav2vec2 audio encoder and a 768 -> feature_dim map, the motion
embedding plus a learned per-subject style, FaceFormer's periodic
positional encoding and ALiBi-biased causal mask, a post-norm ReLU
transformer decoder over the audio with the alignment mask, a zero-init
``feat_map`` to ``face_quan_num * zquant_dim`` pre-quant features, and the
frozen vertex VQ (the port's ``VQAutoEncoder``, whose quantizer runs K4).
Losses: motion MSE plus the regression of the features onto the ground
truth's quantized latents.

Parameters are named as the reference's (``audio_encoder``,
``audio_feature_map``, ``vertice_map``, ``PPE``, ``transformer_decoder``
with torch ``nn.TransformerDecoder``'s keys, ``feat_map``,
``learnable_style_emb``, ``autoencoder``), so a reference checkpoint loads
with ``strict=True`` through ``codetalker_state_dict``. As in the JAX
package, the decoder has no dropout, its LayerNorms take flax's eps 1e-6,
and its attention gives zeros (not NaN) for a row whose every key is masked.

``predict`` runs the reference's algorithm: each frame re-runs the decoder
over the motion prefix and VQ-decodes it to feed the last frame back. It
grows the prefix as the reference does, where the JAX package keeps a
fixed-length buffer with validity masks; the VQ decode takes ``lengths``
as the JAX loop's does, so both give the same codes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.positional import PeriodicPositionalEncoding, enc_dec_mask, init_biased_mask
from .vq_vae import VQAutoEncoder
from .wav2vec2 import W2VConfig, Wav2Vec2Model, materialize_pos_conv

# frozen in stage 2: the wav2vec2 conv extractor (stage2.py:20) and the whole
# stage-1 autoencoder (stage2.py:46-47)
CODETALKER_FROZEN = ("audio_encoder.feature_extractor", "autoencoder")
MAX_SEQ_LEN = 600  # the biased mask's and the periodic encoding's length


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``), batch-first, as plain matrix products:
    an additive (H, Lq, Lk) ``bias`` and a bool (Lq, Lk) ``mask`` (True =
    masked); a query row with no visible key gives zeros."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, kv: torch.Tensor, bias: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, lq, d = x.shape
        hd = d // self.heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def split(y):
            return y.reshape(b, y.shape[1], self.heads, hd).transpose(1, 2)

        q = split(F.linear(x, wq, bq))
        k, v = split(F.linear(kv, wk, bk)), split(F.linear(kv, wv, bv))
        dots = (q @ k.transpose(-1, -2)) * hd ** -0.5
        if bias is not None:
            dots = dots + bias[None]
        if mask is not None:
            dots = dots.masked_fill(mask, float("-inf"))
        live = torch.isfinite(dots).any(dim=-1, keepdim=True)
        attn = torch.softmax(dots.masked_fill(~live, 0.0), dim=-1) * live
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, lq, d))


class DecoderLayer(nn.Module):
    """torch ``nn.TransformerDecoderLayer`` (post-norm, ReLU feed-forward):
    self-attention under the biased causal mask, cross-attention over the
    audio under the alignment mask, feed-forward, each added and normed."""

    def __init__(self, dim: int, heads: int, ff_dim: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.multihead_attn = MultiheadAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ff_dim)
        self.linear2 = nn.Linear(ff_dim, dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=1e-6) for _ in range(3))

    def forward(self, x, memory, tgt_bias, memory_mask):
        x = self.norm1(x + self.self_attn(x, x, tgt_bias))
        x = self.norm2(x + self.multihead_attn(x, memory, mask=memory_mask))
        return self.norm3(x + self.linear2(F.relu(self.linear1(x))))


class TransformerDecoder(nn.Module):
    def __init__(self, dim: int, heads: int, ff_dim: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(dim, heads, ff_dim) for _ in range(num_layers))

    def forward(self, x, memory, tgt_bias, memory_mask):
        for layer in self.layers:
            x = layer(x, memory, tgt_bias, memory_mask)
        return x


class CodeTalker(nn.Module):
    """The stage-2 speech-to-motion model."""

    def __init__(self, cfg, w2v_cfg: Optional[W2VConfig] = None):
        super().__init__()
        if cfg.in_dim != cfg.vertice_dim:
            raise ValueError(f"stage 2's VQ decodes motion of in_dim ({cfg.in_dim}), which must "
                             f"equal vertice_dim ({cfg.vertice_dim}): the vertex VQ")
        self.cfg = cfg
        w2v_cfg = w2v_cfg or W2VConfig()
        d = cfg.feature_dim
        self.audio_encoder = Wav2Vec2Model(w2v_cfg)
        self.audio_feature_map = nn.Linear(w2v_cfg.hidden_size, d)
        self.vertice_map = nn.Linear(cfg.vertice_dim, d)
        self.PPE = PeriodicPositionalEncoding(d, period=cfg.period, max_seq_len=MAX_SEQ_LEN,
                                              dropout=0.0)
        self.transformer_decoder = TransformerDecoder(d, cfg.n_head, 2 * d, cfg.num_layers)
        self.feat_map = nn.Linear(d, cfg.face_quan_num * cfg.zquant_dim, bias=False)
        nn.init.zeros_(self.feat_map.weight)
        self.learnable_style_emb = nn.Embedding(len(cfg.train_subjects.split()), d)
        variant = "vocaset" if cfg.get("autoencoder", "stage1_BIWI") == "stage1_vocaset" \
            else "BIWI"
        self.autoencoder = VQAutoEncoder(cfg, variant=variant)
        self.register_buffer("biased_mask", init_biased_mask(cfg.n_head, MAX_SEQ_LEN, cfg.period),
                             persistent=False)

    def _decode_feats(self, vertice_input: torch.Tensor, hidden_states: torch.Tensor,
                      memory_mask: torch.Tensor) -> torch.Tensor:
        lt = vertice_input.shape[1]
        h = self.transformer_decoder(vertice_input, hidden_states,
                                     self.biased_mask[:, :lt, :lt], memory_mask[:lt])
        return self.feat_map(h)

    def _style(self, one_hot: torch.Tensor) -> torch.Tensor:
        return self.learnable_style_emb(one_hot.argmax(dim=1))

    def forward(self, audio: torch.Tensor, template: torch.Tensor, vertice: torch.Tensor,
                one_hot: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """The teacher-forced training pass (stage2.py:50-98). audio (B,
        samples), template (B, V*3), vertice (B, L, V*3), one_hot (B,
        n_subjects) -> (weighted loss, (motion loss, regression loss))."""
        cfg = self.cfg
        template = template[:, None, :]
        obj_emb = self._style(one_hot)[:, None, :]
        frame_num = vertice.shape[1]
        hidden_states = self.audio_encoder(audio, cfg.dataset, frame_num=frame_num)
        if cfg.dataset == "BIWI" and hidden_states.shape[1] < frame_num * 2:
            frame_num = hidden_states.shape[1] // 2
            vertice = vertice[:, :frame_num]
        hidden_states = self.audio_feature_map(hidden_states)

        with torch.no_grad():  # the regression target, stop_gradient in the JAX package
            feat_q_gt = self.autoencoder.get_quant(vertice - template)[0].transpose(1, 2)

        vertice_input = torch.cat([template, vertice[:, :-1]], dim=1) - template
        vertice_input = self.PPE(self.vertice_map(vertice_input) + obj_emb)
        mask = enc_dec_mask(cfg.dataset, frame_num, hidden_states.shape[1], audio.device)
        feat_out = self._decode_feats(vertice_input, hidden_states, mask)
        feat_out = feat_out.reshape(feat_out.shape[0], frame_num * cfg.face_quan_num, -1)
        q = self.autoencoder.quantize(feat_out)
        vertice_out = self.autoencoder.decode(q.z_q) + template

        loss_motion = (vertice_out - vertice).square().mean()
        loss_reg = (feat_out - feat_q_gt).square().mean()
        total = (cfg.get("motion_weight", 1.0) * loss_motion
                 + cfg.get("reg_weight", 1.0) * loss_reg)
        return total, (loss_motion, loss_reg)

    @torch.no_grad()
    def predict(self, audio: torch.Tensor, template: torch.Tensor, one_hot: torch.Tensor,
                one_hot2: Optional[torch.Tensor] = None,
                weight_of_one_hot: Optional[float] = None) -> torch.Tensor:
        """Autoregressive inference (stage2.py:102-157): (B, frames, V*3)
        motion, one K4 launch a frame. ``one_hot2`` with ``weight_of_one_hot``
        blends two subjects' styles."""
        cfg = self.cfg
        fq = cfg.face_quan_num
        template = template[:, None, :]
        style = self._style(one_hot)
        if one_hot2 is not None and weight_of_one_hot is not None:
            style = style * weight_of_one_hot + self._style(one_hot2) * (1 - weight_of_one_hot)
        style = style[:, None, :]

        hidden_states = self.audio_encoder(audio, cfg.dataset)
        frame_num = (hidden_states.shape[1] // 2 if cfg.dataset == "BIWI"
                     else hidden_states.shape[1])
        hidden_states = self.audio_feature_map(hidden_states)
        mask = enc_dec_mask(cfg.dataset, frame_num, hidden_states.shape[1], audio.device)
        b = audio.shape[0]

        emb = style
        for i in range(1, frame_num):
            feat_out = self._decode_feats(self.PPE(emb), hidden_states, mask)
            q = self.autoencoder.quantize(feat_out.reshape(b, i * fq, -1))
            lengths = torch.full((b,), i * fq, dtype=torch.long, device=audio.device)
            last = self.autoencoder.decode(q.z_q, lengths=lengths)[:, -1]
            emb = torch.cat([emb, (self.vertice_map(last) + style[:, 0])[:, None]], dim=1)

        feat_out = self._decode_feats(self.PPE(emb), hidden_states, mask)
        q = self.autoencoder.quantize(feat_out.reshape(b, frame_num * fq, -1))
        return self.autoencoder.decode(q.z_q) + template


def codetalker_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference ``stage2`` state_dict with its audio encoder's
    weight-normed positional conv materialised, ready for a strict load."""
    return materialize_pos_conv(state_dict, prefix="audio_encoder.")
