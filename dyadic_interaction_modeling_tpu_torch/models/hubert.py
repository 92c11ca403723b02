"""HuBERT audio features (reference dataset/biwi.py:83-113).

Counterpart of ``dyadic_interaction_modeling_tpu/models/hubert.py``:
HuBERT-base is the wav2vec2-base trunk (``Wav2Vec2Model``) with HuBERT
weights from an s3prl, fairseq or HF state_dict (``normalize_hubert_keys``
maps the three layouts onto HF's wav2vec2 keys, :47-107), loaded strictly:
a key that neither maps into the trunk nor is one of fairseq's pretraining
heads (``HUBERT_DROP_KEYS``) raises (:148-170). ``interpolate_to_length`` is
the reference's 50 fps -> motion-frame alignment.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .wav2vec2 import POS_CONV, W2VConfig, Wav2Vec2Model, hf_state_dict, linear_interpolation


def hubert_base_config() -> W2VConfig:
    """HuBERT-base's trunk: the wav2vec2-base dimensions."""
    return W2VConfig()


class HubertModel(Wav2Vec2Model):
    """HuBERT-base's forward is the wav2vec2 trunk's."""


def interpolate_to_length(features: torch.Tensor, new_t: int) -> torch.Tensor:
    """(T, C) or (B, T, C) -> ``new_t`` frames by linear align_corners
    interpolation (biwi.py:37-43)."""
    if features.dim() == 2:
        return linear_interpolation(features[None], 1, 1, output_len=new_t)[0]
    return linear_interpolation(features, 1, 1, output_len=new_t)


# fairseq HuBERT's pretraining heads (the masked-target codebook and its
# projection): no role in extraction, so dropped by name
HUBERT_DROP_KEYS = ("label_embs_concat", "final_proj.weight", "final_proj.bias")


def normalize_hubert_keys(state_dict: Mapping[str, Any]) -> Tuple[Dict[str, Any], list]:
    """s3prl (``upstream.model.``), fairseq and HF ``HubertModel``
    (``hubert.``) layouts -> HF wav2vec2 keys. Returns (normalized dict, the
    dropped original keys): every input key is one or the other."""
    sd: Dict[str, Any] = {}
    dropped = []
    for orig, v in state_dict.items():
        k = orig
        while True:  # nesting wrappers: upstream.model.hubert. ...
            for pre in ("upstream.", "model.", "hubert."):
                if k.startswith(pre):
                    k = k[len(pre):]
                    break
            else:
                break
        if any(k == d or k.startswith(d) for d in HUBERT_DROP_KEYS):
            dropped.append(orig)
            continue
        k = re.sub(r"^feature_extractor\.conv_layers\.(\d+)\.0\.",
                   r"feature_extractor.conv_layers.\1.conv.", k)
        k = re.sub(r"^feature_extractor\.conv_layers\.0\.2\.",
                   "feature_extractor.conv_layers.0.layer_norm.", k)
        if k.startswith("layer_norm."):  # fairseq's LayerNorm before the projection
            k = "feature_projection." + k
        k = k.replace("post_extract_proj.", "feature_projection.projection.")
        if k == "mask_emb":
            k = "masked_spec_embed"
        k = k.replace("encoder.pos_conv.0.", "encoder.pos_conv_embed.conv.")
        k = re.sub(r"^(encoder\.layers\.\d+)\.self_attn_layer_norm\.", r"\1.layer_norm.", k)
        k = re.sub(r"^(encoder\.layers\.\d+)\.self_attn\.", r"\1.attention.", k)
        k = re.sub(r"^(encoder\.layers\.\d+)\.fc1\.", r"\1.feed_forward.intermediate_dense.", k)
        k = re.sub(r"^(encoder\.layers\.\d+)\.fc2\.", r"\1.feed_forward.output_dense.", k)
        sd[k] = v
    return sd, dropped


def _known_keys(cfg: W2VConfig) -> set:
    """Every normalized key the trunk takes (read off a model on the meta
    device), the positional conv's weight under each of its three
    spellings."""
    with torch.device("meta"):
        keys = set(Wav2Vec2Model(cfg).state_dict())
    keys |= {f"{POS_CONV}.{k}" for k in ("weight_g", "weight_v",
                                         "parametrizations.weight.original0",
                                         "parametrizations.weight.original1")}
    # HF's HubertModel and fairseq keep conv 0's bias slot even without conv_bias
    keys.add("feature_extractor.conv_layers.0.conv.bias")
    return keys


def hubert_state_dict(state_dict: Mapping[str, Any],
                      cfg: Optional[W2VConfig] = None) -> Dict[str, torch.Tensor]:
    """An s3prl / fairseq / HF HuBERT state_dict in ``HubertModel``'s keys.
    Raises ``KeyError`` for a key that maps nowhere; a missing
    ``masked_spec_embed`` (an extraction-only file) becomes zeros; conv 0's
    bias is dropped when the config has no conv biases."""
    cfg = cfg or hubert_base_config()
    sd, _ = normalize_hubert_keys(state_dict)
    unknown = sorted(set(sd) - _known_keys(cfg))
    if unknown:
        raise KeyError(f"{len(unknown)} HuBERT keys did not map, e.g. {unknown[:6]}")
    if not cfg.conv_bias:
        sd.pop("feature_extractor.conv_layers.0.conv.bias", None)
    sd.setdefault("masked_spec_embed", np.zeros((cfg.hidden_size,), np.float32))
    return hf_state_dict(sd)


def load_hubert_checkpoint(path: str, cfg: Optional[W2VConfig] = None
                           ) -> Dict[str, torch.Tensor]:
    """A torch HuBERT checkpoint file -> ``HubertModel``'s state_dict: the
    s3prl downstream file (its ``Upstream`` entry, biwi.py:85-89), a
    ``{'state_dict': ...}`` wrapper or a plain fairseq / HF state_dict."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "Upstream" in sd:
        sd = sd["Upstream"]
    elif isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return hubert_state_dict(sd, cfg)


def make_hubert_extractor(checkpoint_path: Optional[str] = None,
                          cfg: Optional[W2VConfig] = None, device="cuda", seed: int = 0
                          ) -> Tuple[Callable[[np.ndarray], np.ndarray], HubertModel]:
    """The waveform -> (T', hidden) feature extractor of the BIWI reader
    (``read_biwi_emoca_data``), on ``device`` (the card unless the CPU is
    asked for). Returns ``(extract, model)``; ``extract`` maps a 16 kHz
    (samples,) array to a numpy (T', hidden) array, no alignment applied.
    Without a checkpoint the trunk is a random init from ``seed``: its
    features serve pipeline runs only."""
    cfg = cfg or hubert_base_config()
    torch.manual_seed(seed)
    model = HubertModel(cfg)
    if checkpoint_path:
        model.load_state_dict(load_hubert_checkpoint(checkpoint_path, cfg), strict=True)
    model = model.to(device).eval()

    def extract(waveform: np.ndarray) -> np.ndarray:
        w = torch.as_tensor(np.asarray(waveform, np.float32), device=device)[None]
        with torch.no_grad():
            return model(w, "none")[0].float().cpu().numpy()

    return extract, model
