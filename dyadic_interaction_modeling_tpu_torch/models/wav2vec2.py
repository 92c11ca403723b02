"""The wav2vec2 audio encoder (reference models/lib/wav2vec.py:69-147).

Counterpart of ``dyadic_interaction_modeling_tpu/models/wav2vec2.py``: the
strided conv feature extractor (7 layers of 512 channels at the base width),
the reference's frame alignment (BIWI trims to an even count and to twice
``frame_num``; vocaset interpolates 50 -> 30 fps, :304-326), the feature
projection, SpecAugment masking with ``masked_spec_embed``, and the
post-norm transformer encoder with its grouped-conv positional embedding.
Attention stays plain matrix products, as the JAX package's einsums do.

Module names follow HF's ``Wav2Vec2Model``, so an HF state_dict, or a
reference ``stage2`` checkpoint's ``audio_encoder.*``, loads with
``strict=True`` once ``hf_state_dict`` has materialised the positional
conv's weight norm (``weight_g``/``weight_v`` or ``parametrizations``),
as ``hf_wav2vec2_to_flax`` (:363-376) does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class W2VConfig:
    """The subset of HF's ``Wav2Vec2Config`` the model needs (defaults: the
    base model)."""

    def __init__(self,
                 conv_dim: Sequence[int] = (512,) * 7,
                 conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2),
                 conv_bias: bool = False,
                 hidden_size: int = 768,
                 num_hidden_layers: int = 12,
                 num_attention_heads: int = 12,
                 intermediate_size: int = 3072,
                 num_conv_pos_embeddings: int = 128,
                 num_conv_pos_embedding_groups: int = 16,
                 feat_extract_norm: str = "group",
                 do_stable_layer_norm: bool = False,
                 mask_time_prob: float = 0.05,
                 mask_time_length: int = 10,
                 mask_feature_prob: float = 0.0,
                 mask_feature_length: int = 10,
                 layer_norm_eps: float = 1e-5):
        self.conv_dim = tuple(conv_dim)
        self.conv_kernel = tuple(conv_kernel)
        self.conv_stride = tuple(conv_stride)
        self.conv_bias = conv_bias
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.num_conv_pos_embeddings = num_conv_pos_embeddings
        self.num_conv_pos_embedding_groups = num_conv_pos_embedding_groups
        self.feat_extract_norm = feat_extract_norm
        self.do_stable_layer_norm = do_stable_layer_norm
        self.mask_time_prob = mask_time_prob
        self.mask_time_length = mask_time_length
        self.mask_feature_prob = mask_feature_prob
        self.mask_feature_length = mask_feature_length
        self.layer_norm_eps = layer_norm_eps

    @classmethod
    def from_hf(cls, hf_config) -> "W2VConfig":
        return cls(**{k: getattr(hf_config, k) for k in cls().__dict__})


def processor_normalize(waveform: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """HF ``Wav2Vec2Processor``'s waveform normalization for
    wav2vec2-base-960h (``do_normalize=True``): per-utterance
    ``(x - mean) / sqrt(var + 1e-7)``, population variance, in float64."""
    x = np.asarray(waveform, dtype=np.float64)
    return ((x - x.mean()) / np.sqrt(x.var() + eps)).astype(np.float32)


def linear_interpolation(features: torch.Tensor, input_fps: int, output_fps: int,
                         output_len: Optional[int] = None) -> torch.Tensor:
    """torch ``F.interpolate(mode='linear', align_corners=True)`` over the
    time axis of (B, T, C) features, the positions taken from float64."""
    b, t, c = features.shape
    if output_len is None:
        output_len = int(t / float(input_fps) * output_fps)
    if output_len == t:
        return features
    pos = np.linspace(0.0, t - 1.0, output_len)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, t - 1)
    w = torch.as_tensor((pos - lo).astype(np.float32), device=features.device)[None, :, None]
    lo, hi = (torch.as_tensor(i, device=features.device) for i in (lo, hi))
    return features[:, lo] * (1 - w.to(features.dtype)) + features[:, hi] * w.to(features.dtype)


def compute_mask_indices(rng: np.random.Generator, shape: Tuple[int, int],
                         mask_prob: float, mask_length: int,
                         min_masks: int = 0) -> np.ndarray:
    """SpecAugment span masking on the host, as the reference's
    (wav2vec.py:11-58): bool (B, T), True = masked."""
    bsz, all_sz = shape
    mask = np.zeros(shape, dtype=bool)
    all_num_mask = int(mask_prob * all_sz / float(mask_length) + rng.random())
    all_num_mask = max(min_masks, all_num_mask)
    mask_idcs = []
    for _ in range(bsz):
        num_mask = all_num_mask
        lengths = np.full(num_mask, mask_length)
        if lengths.sum() == 0:
            lengths[0] = min(mask_length, all_sz - 1)
        min_len = int(lengths.min())
        if all_sz - min_len <= num_mask:
            min_len = all_sz - num_mask - 1
        starts = rng.choice(all_sz - min_len, num_mask, replace=False)
        idc = np.asarray([s + off for s, le in zip(starts, lengths) for off in range(le)])
        mask_idcs.append(np.unique(idc[idc < all_sz]))
    min_len = min(len(m) for m in mask_idcs)
    for i, idc in enumerate(mask_idcs):
        if len(idc) > min_len:
            idc = rng.choice(idc, min_len, replace=False)
        mask[i, idc] = True
    return mask


class ConvLayer(nn.Module):
    """conv -> [norm] -> exact GELU on (B, C, T). ``norm``: ``group`` (one
    group a channel, over time), ``layer`` (over channels) or ``none``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, bias: bool,
                 norm: str, eps: float):
        super().__init__()
        self.norm = norm
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=bias)
        if norm == "group":
            self.layer_norm = nn.GroupNorm(c_out, c_out, eps=eps, affine=True)
        elif norm == "layer":
            self.layer_norm = nn.LayerNorm(c_out, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm == "group":
            x = self.layer_norm(x)
        elif self.norm == "layer":
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: W2VConfig):
        super().__init__()
        layers, c_in = [], 1
        for i, (d, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            if cfg.feat_extract_norm == "group":
                norm = "group" if i == 0 else "none"
            else:
                norm = "layer"
            layers.append(ConvLayer(c_in, d, k, s, cfg.conv_bias, norm, cfg.layer_norm_eps))
            c_in = d
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:
        """(B, samples) -> (B, T', conv_dim[-1])."""
        x = input_values[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: W2VConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class PosConvEmbedding(nn.Module):
    """Grouped conv over time, ``k // 2`` zeros each side, the trailing step
    dropped at an even kernel (HF ``Wav2Vec2SamePadLayer``), exact GELU."""

    def __init__(self, cfg: W2VConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x.transpose(1, 2))
        if self.conv.kernel_size[0] % 2 == 0:
            h = h[:, :, :-1]
        return F.gelu(h).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads

        def split(y):
            return y.reshape(b, t, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        attn = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, t, d))


class FeedForward(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(dim, inner)
        self.output_dense = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-norm: x = LN(x + attn(x)); x = LN(x + ff(x))."""

    def __init__(self, cfg: W2VConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = Attention(d, cfg.num_attention_heads)
        self.layer_norm = nn.LayerNorm(d, eps=eps)
        self.feed_forward = FeedForward(d, cfg.intermediate_size)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, cfg: W2VConfig):
        super().__init__()
        self.pos_conv_embed = PosConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm(h + self.pos_conv_embed(h))
        for layer in self.layers:
            h = layer(h)
        return h


class Wav2Vec2Model(nn.Module):
    """The audio encoder with the reference's frame alignment."""

    def __init__(self, cfg: Optional[W2VConfig] = None):
        super().__init__()
        self.cfg = cfg = cfg or W2VConfig()
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.masked_spec_embed = nn.Parameter(torch.empty(cfg.hidden_size).uniform_())
        self.encoder = Encoder(cfg)

    def forward(self, input_values: torch.Tensor, dataset: str = "BIWI",
                frame_num: Optional[int] = None,
                mask_time_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, samples) -> (B, T, hidden): conv features, the alignment of
        ``dataset`` (``BIWI``, ``vocaset``, anything else none), projection,
        ``masked_spec_embed`` where the bool (B, T) ``mask_time_indices``
        is set (from ``compute_mask_indices``), encoder."""
        h = self.feature_extractor(input_values)
        if dataset == "BIWI":
            if h.shape[1] % 2 != 0:
                h = h[:, :-1]
            if frame_num is not None and h.shape[1] > frame_num * 2:
                h = h[:, : frame_num * 2]
        elif dataset == "vocaset":
            h = linear_interpolation(h, 50, 30, output_len=frame_num)
        h = self.feature_projection(h)
        if mask_time_indices is not None:
            m = torch.as_tensor(mask_time_indices, device=h.device)[:, :, None]
            h = torch.where(m, self.masked_spec_embed.to(h.dtype), h)
        return self.encoder(h)


POS_CONV = "encoder.pos_conv_embed.conv"


def materialize_pos_conv(state_dict: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``state_dict`` with the positional conv's weight norm (``weight_g`` /
    ``weight_v``, or ``parametrizations.weight.original0`` / ``original1``)
    replaced by the plain ``weight`` it stands for: torch's
    ``weight_norm(dim=2)``, g * v / ||v|| with the norm over the output and
    input channels."""
    base = prefix + POS_CONV
    sd = dict(state_dict)
    for g_key, v_key in ((f"{base}.weight_g", f"{base}.weight_v"),
                         (f"{base}.parametrizations.weight.original0",
                          f"{base}.parametrizations.weight.original1")):
        if g_key in sd:
            g = torch.as_tensor(sd.pop(g_key)).double()
            v = torch.as_tensor(sd.pop(v_key)).double()
            sd[f"{base}.weight"] = (g * v / v.square().sum(dim=(0, 1), keepdim=True).sqrt()
                                    ).float()
    return sd


def hf_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An HF ``Wav2Vec2Model`` (or ``Wav2Vec2For*``'s ``wav2vec2.``-prefixed)
    state_dict in this module's keys."""
    sd = {k.replace("wav2vec2.", ""): torch.as_tensor(v) for k, v in state_dict.items()}
    return materialize_pos_conv(sd)


def load_hf_wav2vec2(state_dict: Mapping[str, Any],
                     cfg: Optional[W2VConfig] = None) -> Wav2Vec2Model:
    """A ``Wav2Vec2Model`` of ``cfg`` (the base model by default) holding an
    HF state_dict, loaded with ``strict=True``."""
    model = Wav2Vec2Model(cfg)
    model.load_state_dict(hf_state_dict(state_dict), strict=True)
    return model
